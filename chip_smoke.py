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
   before those calls, and every kernel of the path (the Hopper K1 of
   ``csrc/fused_layer_fwd_sm90.cu`` and the Hopper K2 of
   ``csrc/fused_layer_bwd_sm90.cu`` 4 times per call each and the general
   K1 and K2 never, the Hopper K3 of ``csrc/rowblock_fwd_sm90.cu`` and the
   Hopper K4 of ``csrc/rowblock_bwd_sm90.cu`` for the compress and
   combination 2 times per call each and for the head once each, the
   general K3 and K4 never, the permute and the accumulate permute) must
   have launched in them; the pair searches must have run in the native
   neighbor library. One call of the f32 kernel path, every counter at 0
   just before it, must launch the Hopper float32 K1 of
   ``csrc/fused_layer_fwd_f32_sm90.cu`` and the Hopper float32 K2 of
   ``csrc/fused_layer_bwd_f32_sm90.cu`` 4 times each and the general K1
   and K2 never,
   and the Hopper float32 K4 of ``csrc/rowblock_bwd_f32_sm90.cu`` (``K4_F32``)
   and the Hopper float32 K3 of ``csrc/rowblock_fwd_f32_sm90.cu``
   (``K3_F32``) 2 + 2 + 1 times each (compress, combination, head) and the
   general K3 and K4 never. Energy, forces and virial must be finite; the bf16
   kernel path must match the f32 plain path (energy rel <= 1 %, force
   rel-RMSE <= 5 %, or 1.25 x the bf16 plain path's own error where that
   is larger) and the f32 kernel path the f32 plain path (energy rel <=
   1e-5, force rel-RMSE <= 1e-4). Then ms per force call and atom-steps/s
   of the kernel and plain paths in both dtypes, and a torch.profiler
   breakdown of the bf16 kernel path.
   GNN block: the same for PET with ``fused_gnn=True``, each GNN layer's
   fused layers and node stream as one block. In bf16 that is the Hopper
   block, a sequence of launches: per call (``GNN_SM90_PER_CALL``) the
   Hopper K1 8 times (4 forward, 4 in the backward's recompute), the Hopper
   K2 4, the node-stream forward kernel of ``csrc/gnn_node_sm90.cu`` 10 and
   its backward 6, 6 block calls each way in the 3 calls, and the general
   block and K1/K2 bodies never; the f32 call is the Hopper float32 block
   (``GNN_F32_PER_CALL``: the Hopper float32 K1 8, K2 4, the float32
   node-stream kernels of ``csrc/gnn_node_f32_sm90.cu`` 10 and 6, 2 block
   calls each way) and launches neither the general block nor a bf16
   Hopper kernel. The plain paths run the block's plain version. The same
   model at a 5.5 A cutoff on 8^3 cells (2,048 atoms, M = 96, 2 steps, no
   timing) runs the general block pair in both dtypes, 2 + 2 a call, and
   no Hopper block.
3b. physics options: two PETs at the defaults on the crystal, served as
   phase 3 in bf16 and f32, kernel and plain, with phase 3's launch counts
   (the Hopper K1/K2, K3/K4 and heads, the general bodies never, both
   permutes) and accuracy gates: (a) ``zbl``, Ewald long range (n_kmax 4)
   and ``system_conditioning`` (its zero-initialised gate drawn from a
   seeded generator); (b) ``num_neighbors_adaptive: 16`` (the solver) with
   PME long range (mesh 32). Each option must have acted: ZBL's energy
   and the long-range features non-zero, a batch with charge 1 and spin
   multiplicity 2 (``extra_keys``, ``evaluate_model``) another energy than
   the neutral singlet, the adaptive cutoffs in [0.5, 4.5] and not 4.5.
   One f32 training step of each on phase 5's first two frames (a charge
   and a spin each), kernel vs plain with phase 6's gates: the Hopper
   float32 K1 (4 times, the general K1 never), K2-dW, the Hopper float32
   K3 (``K3_F32``, 2 + 2 + 1 times; the general K3 never) and K4-dW must
   launch and the layer's replay run. Reported, not gated:
   ms per call and atom-steps/s beside phase 3's, each option's own
   CUDA-event time (forward and backward to the positions) and whether
   the long-range featurizer repeats bit for bit, a profile of (b).
3c. generic targets: PET at the defaults (random weights from a seeded
   generator) with six targets: the energy with forces and virial, a
   4-member ensemble with its own forces (LLPR's layout), per-atom
   charges, a dipole (Cartesian rank 1), a polarizability (spherical (0,
   1) and (2, 1)) and the non-conservative stress, plus the aux outputs
   ``features`` and the energy's last-layer features, all in one bf16
   call (``evaluate_model(forward_eval)``) on the crystal's served batch
   (the calculator's list and padding). Every counter starts at 0 just
   before two such calls; the launches per call must equal
   ``GENERIC_PER_CALL`` (the Hopper K1 4, K2 20: one backward pass for
   the energy and one per member; K3 compress, combination and heads 2 /
   2 / 6; K4 10 / 10 / 5; permute 2, accumulate permute 10; the general
   bodies never). Gates against the f32 plain path: phase 3's for the
   energy (1 %) and for forces and virial (5 %), 5 % relative RMS for
   every other output, or 1.25 x the bf16 plain path's own error; the f32
   kernel path 1e-5 (energy) and 1e-4. Each member's forces equal a call
   seeding that member alone to 1e-6 relative (f32 kernel path). Timed:
   the all-outputs call, the same without the members' forces (their
   difference is the property loop) and the energy-only force call. One
   f32 training step on phase 5's first two frames with generic labels
   from their positions (mse energy and forces, huber charges, mae
   dipole, shift-agnostic mse polarizability; both batches rotated by an
   O3 augmenter of seed 0), kernel vs plain with phase 6's gates, the
   Hopper float32 K1 4 times (the general K1 never), K3, K2-dW and K4-dW
   launched, a Hopper float32 K3 head per target and at least one Hopper
   float32 K4-dW head per target. ``mtt::aux::cutoff_stats`` of phase
   3b's adaptive model (b), bf16 kernel vs f32 plain path, 1e-5. The
   ``eval`` command in this process on the model saved as ``.mtt`` and the
   two frames: its ``.xyz`` read back equals the in-process predictions to
   1e-5 relative.
4. unfused slice: the same for PET with ``fused_layers: false`` (the
   layout of a v1 checkpoint at the default widths): the window attention
   forward and backward, both permutes and the row-block stages must
   launch, the row-block kernels as on the fused path; then, with the same
   gates and no timing, LayerNorm / SiLU / PostLN layers with the residual
   featurizer (2 GNN layers of 1 attention layer: the Hopper K3 and K4 for
   the compress 2 times per call each, no combination, the Hopper heads
   twice).
4b. W8A8 slice: the fused model of phase 3 built with
   ``int8_static=True`` in bfloat16, ``calibrate_int8`` on the crystal's
   served batch (the calibration carried to the W8A8 plain model with
   ``int8_calib_from_jax(int8_calib_to_jax(...))``), then the same served
   calls: every counter starts at 0 just before them; the Hopper K1-W8A8
   and K2-W8A8 (the W8A8 mode of the Hopper K1 and K2, ``W8A8_SM90``) must
   launch 4 times per call each (2 GNN x 2 layers), the general W8A8
   bodies and the exact K1/K2 never, K3, K4 (the Hopper K3 and K4
   included) and both permutes as on the fused path.
   Gates: finite outputs;
   W8A8 kernel path vs W8A8 plain path (both bf16) energy rel <= 1 %,
   force rel-RMSE <= 5 %; the W8A8 forces differ from the exact bf16 kernel
   path's (rel-RMSE > 1e-4: quantization ran). Reported, not gated: the
   errors of the W8A8 and exact bf16 paths against the f32 exact plain
   path, relative and in ``bench.py``'s MAE-gate terms (meV/atom, meV/A,
   virial meV/atom); ms per call and atom-steps/s of the W8A8 and exact bf16
   kernel paths; a torch.profiler breakdown of the W8A8 call.
4c. larger windows and widths: the fused model of phase 3 with a 5.5 A
   cutoff (the calculator's buckets give M = 96 on the crystal; any M >= 80
   passes, a smaller one fails) and with d_pet 256, d_ff 512, 8 heads of 32,
   each served as phase 3 (its launches and gates, 2 steps; the general K1
   and K2 bodies, the f32 call's too: 4 general K1 and no Hopper float32
   K1; at M = 96 the Hopper K3 and K4, at d_pet 256 the general
   K3 and K4: the compress and combination 2 per call each, the head 1;
   the f32 call's row blocks at M = 96 the Hopper float32 K3 and K4 2 + 2
   + 1 times each, at d_pet 256 the general K3 and K4, the head's
   included), the kernel paths timed.
4d. int8 scores: the fused model built with ``int8_scores=True`` in
   bfloat16: every counter starts at 0 just before its served calls; the
   Hopper absmax pass (``int8_absmax_sm90``) and the Hopper K1-int8 and
   K2-int8 (the int8-score mode of the Hopper K1 and K2, ``INT8_SM90``)
   must launch 4 times per call each, the general absmax pass, the general
   K1-int8 and K2-int8 and the exact K1/K2 never, the
   row-block backward as on the fused path. Gates: finite
   outputs; the int8 kernel path vs its plain
   path energy rel <= 1 %, force rel-RMSE <= 5 %; its forces differ from
   the exact bf16 kernel path's (rel-RMSE > 1e-4). Reported, not gated: its
   error against the f32 exact plain path (relative, MAE terms), ms per
   call beside the exact bf16 path's, a profile.
5. training: 8 frames of Cu FCC 8^3 * 4 = 2,048 atoms (a = 3.6 A, jitter
   0.1 A, ``default_rng(2)``) labelled with a Lennard-Jones energy and its
   analytic forces, written as extended xyz, then the port's
   ``train_model`` at the PET defaults in float32 (batch 2, 2 epochs,
   validation 0.25, forces weight 10). Every counter starts at 0 just
   before it; the Hopper float32 K1 (and never the general K1), K3 (every
   stage the Hopper float32 K3, ``K3_F32``, and never the general body),
   K2-dW and K4-dW (all three stages) must launch in it
   (K2-dW: the two-pass kernels with the Hopper float32 K2's spill mode as
   first pass, ``K2DW_F32``, and never the accumulate body or the general
   body's first pass; K4-dW: the two-pass kernels with the Hopper float32
   K4's spill mode as first pass, ``K4DW_F32``, and never the general
   body)
   and the second-order replays must run; every logged loss must be
   finite; ``model.ckpt`` must reload into a PET that gives the trained
   model's energy. Then W8A8 at the trained weights: ``model.ckpt``
   loaded by ``pet_from_checkpoint(..., int8_static=True)`` (composition
   and scaler included), calibrated on the crystal and served once, with
   phase 4b's gates and errors (no timing).
6. training parity: one step's loss and parameter gradients on 2 frames,
   float32 kernel path vs float32 plain path, for the trained fused model,
   for a random unfused one (whose step must launch the attention and
   permute kernels and replay the attention's backward) and for the
   trained model with ``fused_gnn=True`` (whose step is the Hopper float32
   block's: exactly ``GNN_F32_PER_STEP``, the Hopper float32 K1 12, the
   two-pass K2-dW 8, the node forward 14, the node backward's spill mode 12
   and its products 8, block calls 2 forward and 4 weight-gradient
   backward, the general block never; and the block's backward replayed):
   loss rel <= 1e-5, global gradient rel L2 <= 1e-4, each
   parameter tensor rel L2 <= 1e-3; the fused step must launch the
   Hopper float32 K1 4 times and the general K1 never, the
   two-pass K2-dW's kernels (``K2DW_F32``) 8 times each (4 layers, in the
   forces' backward and in the loss's) and the accumulate body and the
   general body's first pass never, ``K4DW_F32`` 4 + 4 + 2 times (10
   products) and ``K3_F32`` 2 + 2 + 1 times, and the general K3 and K4-dW
   never. Then one
   bfloat16 step with the int8 scores (the trained model), kernel vs plain
   path: the general absmax pass and the general K1-int8 (4 each: weights
   require grad, so not the Hopper pair) and the two-pass K2-dW-int8 (8)
   must launch, the accumulate K2-dW-int8 and the Hopper int8 pair and
   absmax pass never, and
   the layer's replay run;
   loss rel <= 2e-2, global gradient rel L2 <= 0.1, finite gradients. Then
   one exact bfloat16 step (the trained model), kernel vs plain path, with
   the same gates: a weight requires grad, so the general K1, the two-pass
   K2-dW (8 each; its first pass the general body, ``K2DW``) and K4-dW must
   launch and the Hopper K1, K2, K3 and K4, the float32 K1, K3, K4 and
   K4-dW and the accumulate K2-dW never; then the exact bfloat16 step of
   the ``fused_gnn`` model (the same gates): the general block's forward
   and weight-gradient kernels, no Hopper block kernel. Phase 3b's f32
   steps hold the f32 step's
   K2-dW and K4-dW counts, phase 3c's its K2-dW counts and K4-dW's kernels.
7. training timing: ms per step and atom-steps/s (host clock around
   synchronised steps after a warm-up step) with the peak device memory,
   for the kernel, plain and GNN-block paths on the 2 x 2,048-atom batch
   (the kernel paths with a torch.profiler breakdown of one step) and for
   the kernel path on the 10,976-atom crystal as a batch of one (the
   GNN-block steps launching ``GNN_F32_PER_STEP`` each); the timed
   steps of the (non-block) kernel paths must launch the Hopper float32 K1
   4 times a step and the general K1 never, ``K2DW_F32`` 8 times a
   step each, the general first pass and the accumulate body never, and
   ``K4DW_F32`` 4 + 4 + 2 (+ 10) times a step, the general K4-dW never.
7b. user entry points, ``metatrain_tpu_torch.__main__.main`` called in
   this process from a temporary directory: ``train`` on phase 5's frames
   (options written as JSON, 1 epoch, float32; every counter starts at 0
   just before it: the Hopper float32 K1 (never the general K1), K3, the
   two-pass K2-dW (``K2DW_F32``) and the two-pass K4-dW (``K4DW_F32``, the
   head's included) must launch, the accumulate K2-dW, the general first
   pass and the general K4-dW never; the final
   evaluation's logged train and validation metrics must be finite);
   ``export`` of its ``model.ckpt`` (the exported and the trained
   ``model.mtt``'s weights must equal the checkpoint's best weights bit for
   bit); ``eval model.mtt`` on the frames with ``-o preds.xyz`` (the f32
   kernel path's metrics within 1e-4 relative of the same eval on a
   ``plain=True`` model; the Hopper float32 K1 launched, the general K1
   never). Then ``Calculator("model.mtt")`` on the crystal,
   f32 kernel vs f32 plain path with phase 3's f32 gates (the Hopper
   float32 K1 and K2 4 times in its call, the general K1 never); ``run_md_nve``
   with the trained weights in bf16 (``pet_from_checkpoint(...,
   compute_dtype=torch.bfloat16)``) on the crystal, 100 steps of 1 fs with
   ``check_interval`` 10 after a 10-step warm-up: every counter starts at
   0 just before it, and the Hopper K1 and K2 must launch 4 times per force
   call (101 calls) and the general K1 and K2 never; the first 10 steps'
   positions within 1e-3 A of the f32 plain path's ``run_md_nve``, or
   within 1.25 x the bf16 plain path's own distance where that is larger
   (phase 3's rule for the force call). The MD weights are the trained
   run's restarted (``--restart auto``) to 30 epochs at a learning rate
   of 1e-3: after one epoch the network's forces are ~100 eV/A and the
   crystal does not stay one (the slot count outgrows the Hopper kernels'
   M <= 64 within 100 fs).
   Reported: ms per MD step and atom-steps/s (host clock around the
   synchronised 100-step run, its first list update and batch build
   included),
   the list rebuilds, ``Calculator.compute``'s ms per call on the same
   model, and the times of one forced list rebuild
   (``compute_neighbor_data`` at cutoff + skin) and one
   ``batch_from_systems`` on the crystal (three each).
7c. disk data, the writers and the MD-engine servers, in 7b's directory
   on its ``model.mtt`` (the 30-epoch weights): (a) phase 5's frames as
   7b's ``train`` read them, written to ``frames.zip``
   (``DiskDatasetWriter``) and ``frames.memmap/``
   (``write_memmap_dataset``); ``train`` for 1 epoch from each with 7b's
   options, each in a directory of its own, every counter at 0 just
   before it: 7b's kernel checks (the Hopper float32 K1 and never the
   general K1, ``K2DW_F32``, ``K4DW_F32`` and ``K3_F32``, never the
   accumulate K2-dW or the general K4-dW), the final evaluation's train
   and validation metrics within 1e-6 relative of 7b's extended-xyz run,
   whether the final weights equal that run's bit for bit and its epoch
   time beside theirs; (b) ``eval model.mtt`` with ``-o`` ``preds.xyz``,
   ``preds.zip``, ``preds.mts`` and ``preds/``, read back with
   ``DiskDataset``, ``load_mts`` and ``MemmapDataset``: the energies equal
   to the ``.xyz``'s bit for bit, the forces within its text's 5e-11, the
   three float64 formats equal to each other bit for bit; ``eval`` with
   the energy target read from an ``.mts`` file (``save_mts`` of the
   frames' labels) within 1e-6 relative of the extended xyz's metrics;
   (c) ``main(["serve", "model.mtt", "--unix", ...])`` in a thread, a
   ``ForceClient`` sending the crystal with a fresh 0.01 A jitter 2 times
   as a warm-up and then 10 times, every counter at 0 before those 10:
   the Hopper float32 K1 and K2 4 times a request, the float32 K3 and K4
   2 + 2 + 1 each, the general K1 and K2 never; each answer within 1e-6
   of max |F| (forces) and 1e-6 relative (energy, virial) of
   ``Calculator("model.mtt").compute(..., stress=True)`` on the same
   positions in the same order, and whether they are equal bit for bit;
   ms per request (host clock at the client) beside ``compute``'s ms per
   call; (d) ``main(["drive", "model.mtt", "crystal.xyz", "--unix", ...])``
   against a minimal i-PI server in a thread (INIT, 5 POSDATA / GETFORCE
   rounds), ms per round at the server: forces within 1e-5 of max |F| and
   energies within 1e-5 relative of a new ``Calculator("model.mtt")``
   given the positions and cell as the wire gave them (through bohr) in
   the same order, so on the driver's reused lists; against calculators
   whose lists are built on each round's own positions, the same pairs
   within the cutoff (checked exactly), forces within 1e-4 of max |F| and
   within 4 times the float32 order noise (the rounds with their atoms
   relabelled), and in float64 on the plain path (the 2,048-atom crystal)
   within 1e-9. Details
   under ``disk_and_servers`` in
   ``chip_smoke.json``.
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
   (+ add) bit for bit. K2-dW and K2-dW-int8 are the two-pass kernels
   (``csrc/fused_layer_bwd_dw_sm90.cu``): their input gradients must equal
   those of the body their first pass runs, bit for bit (float32 at the
   served shape: the Hopper float32 K2's, the accumulate body then held to
   the float32 bound of the plain version; else the accumulate body's,
   ``sm90=False``), that body is timed
   beside them (``general_ms``), the bytes of their spill, partials and
   workspace are reported (``workspace_bytes``), and their second pass
   alone (``layer_dw_product_cuda``) on one chunk's rows is held to
   ``dw_from_operands`` at the weight-gradient bounds below and timed
   (``product_ms``). The weight gradients of K2-dW, K4-dW and the GNN
   block's dW variant sum over up to A * M rows: float32 max |kernel -
   plain| <= 1e-3 max |plain| per tensor, bfloat16 relative RMS <= 2e-2;
   two launches on the same inputs must give bitwise-equal weight
   gradients. The GNN block (2 attention layers, d_node = 256) also gets
   the time of the per-layer path it replaces (``per_layer_ms``: K1 or K2
   per layer and the node stream in PyTorch ops; the forward with no weight
   requiring grad, as served). Its general kernels are held with
   ``sm90=False`` (``gnn_block_{fwd,bwd,bwd_dw}``); the Hopper block
   (``gnn_block_{fwd,bwd}_sm90``, bf16; ``gnn_block_{fwd,bwd,bwd_dw}_f32_sm90``,
   float32 at the float32 bounds and the weight-gradient bound, its bound
   at the 3xTF32 peak and the FFMA bound beside, the general block's ms
   beside) is held to the plain version at the served shape and, under
   ``shapes``, at M = 64, 48, 16 and 1 or 3 layers with and without the
   expansion (d_node 256; 128 at M = 64, 2 layers; A = 1,024; each run
   launching the Hopper layer kernels and the node kernels and never the
   general block); its backward's recomputed per-layer values must equal
   the forward's bit for bit (float32: the weight-gradient backward's too,
   against the forward with weight gradients) and two launches of it the
   same bits. The node-stream kernels (``gnn_node_{fwd,bwd}_sm90``,
   ``gnn_node_{fwd,bwd,bwd_dw}_f32_sm90``) alone in every mode against
   ``node_stream_{fwd,bwd,bwd_dw}_math``, timed in the middle layer's; the
   float32 spill mode's outputs bitwise the input-gradient mode's, its
   products against ``node_stream_dw_math`` and bitwise on a repeat
   (``product_ms``). K1-W8A8 and K2-W8A8 (the Hopper pair, the general
   bodies through ``sm90=False`` beside, ``general_ms``) at the served
   shape and at M = 48 and 16 (A = 11,000) in bfloat16 only (relative RMS
   <= 2e-2 per output, and told from the exact mode by
   ``compare_int8_mode``, both bodies; the Hopper pair bitwise on a repeat,
   its shared bytes and ``-Xptxas -v`` registers and spills reported), a
   calibration from the plain probe on the same inputs; their bound counts
   the int8 products at 1,979 TOPS and the bf16 ones at 989 TFLOP/s. The
   int8 scores' absmax passes (the general one and the Hopper one, its
   general_ms the general pass's; scales within one bf16 ulp of the plain
   version's, the Hopper pass bitwise on a repeat and, through
   ``tools/sm90_front.py``'s K1-int8 copy at A = 2,047 and M = 64, 48, 16,
   bitwise the per-block max of the q and k that the Hopper K1-int8
   quantizes; registers and spills), K1-int8 and K2-int8 (the Hopper
   pair, the general bodies through ``sm90=False`` beside, ``general_ms``, each held to the plain
   version too; both bitwise on a repeat; each also told from the exact
   mode by ``compare_int8_mode``: its error under half the int8 plain
   version's distance from the exact one, and its step from the exact
   plain version along the int8 mode's, 1 +- 0.2) and K2-dW-int8 at the served
   shape and at M = 48 and 16 (A = 11,000: blocks of 128, the last one
   partial), bfloat16, relative RMS <= 2e-2. K2 in bf16 at the served shape is the Hopper K2:
   its d_cf must be bitwise equal across two launches, the general body
   (``sm90=False``) is held to the same twin and timed beside it
   (``general_ms``), its ``-Xptxas -v`` registers and spills are
   reported; the same at M = 64, 48, 16 (A = 11,000) and M = 32 (A =
   1,000) under ``shapes``. K2 in float32 at those shapes is the Hopper
   float32 K2, an entry of its own (``fused_layer_bwd_f32_sm90``): max
   |kernel - plain| <= 1e-4 max |plain|, all three outputs bitwise equal
   across two launches, the general body (``sm90=False``) held to the same
   bound and timed beside it (``general_ms``), its ``-Xptxas -v``
   registers and spills and its shared bytes per block, its bound at the
   3xTF32 tensor-core peak (495 / 3 TFLOP/s, ``bound_ms``) and on the FFMA
   pipes (``bound_ms_ffma``), with the same shapes; the entry of K2
   (``fused_layer_bwd``) keeps the general body in float32. K1 in bf16 at
   those shapes is the Hopper K1,
   an entry of its own (``fused_layer_fwd_sm90``) with the same checks
   (both outputs bitwise equal across two launches); the entry of K1
   (``fused_layer_fwd``) keeps the general body, in bf16 with
   ``sm90=False``, and its launches are the exact bf16 step's. K1 in
   float32 at those shapes is the Hopper float32 K1, an entry of its own
   (``fused_layer_fwd_f32_sm90``) with the Hopper float32 K2's checks (max
   |kernel - plain| <= 1e-4 max |plain|, both outputs bitwise equal across
   two launches, the general body held to the same bound and timed beside
   it, registers and spills, shared bytes, its bound at the 3xTF32 peak and
   on the FFMA pipes, the same shapes); K1's entry keeps the general body
   in float32 too (``sm90=False``). K4's compress
   and combination in bf16 are the Hopper K4, entries of their own
   (``rowblock_bwd_sm90[<stage>]``): every output within relative RMS 2e-2
   of the plain version and bitwise equal across two launches, the general
   body (``sm90=False``) timed beside it (``general_ms``), its ``-Xptxas
   -v`` registers and spills; the same for the 2-part compress and at A x M
   rows for M = 48 and 16 (A = 11,000) and at 100,003 rows under
   ``shapes``. ``rowblock_bwd[<stage>]`` keeps the general body in bf16
   (``sm90=False``), its launches the d_pet 256 calls'. K4's bound counts
   the inputs it reads (not the combination's messages), g, its outputs and
   its three products; K4-dW's (compress, combination) the same bytes, the
   float weight gradients and five products. K4 and K4-dW's compress,
   combination and head in float32 are the Hopper float32 K4 and the
   two-pass K4-dW,
   entries of their own (``rowblock_bwd_f32_sm90[<stage>]``,
   ``rowblock_bwd_dw_f32_sm90[<stage>]``): input cotangents within 1e-4 of
   max |plain|, weight gradients at ``compare_dw``'s bounds, every output
   bitwise equal across two launches, K4-dW's input cotangents equal to
   K4's, the general body (``sm90=False``) timed beside (``general_ms``),
   the second pass alone on one chunk of the plan (``product_ms``), bounds
   at the 3xTF32 peak and on the FFMA pipes, registers and shared bytes;
   the same for the 2-part compress, and for the 3-part compress and the
   combination at A = 11,000 x M = 48 and at 100,003 rows, and for the
   head also at M = 64 and 16, under ``shapes``.
   ``rowblock_bwd_dw[<stage>]`` keeps the general body (``sm90=False``),
   its launches the exact bf16 step's. K3's compress, combination and head
   in float32 are the Hopper float32 K3, entries of their
   own (``rowblock_fwd_f32_sm90[<stage>]``): output within 1e-4 of max
   |plain|, bitwise equal across two launches and with ``weight_grads``,
   the general body timed beside (``general_ms``), bounds at the 3xTF32
   peak and on the FFMA pipes, registers and shared bytes; the same for
   the 2-part compress, and for the 3-part compress and the combination
   at A = 11,000 x M = 64, 48 and 16 and at 100,003 rows, under
   ``shapes`` (the head at the same rows). ``rowblock_fwd[<stage>]`` keeps
   the general body in float32 (``sm90=False``). The f32 heads share one
   forward: copies of the f32 K3 head and the f32 K4 head instrumented by
   ``tools/sm90_front.py`` (built beside the kernels) must give pre0, h0
   and pre1 bitwise equal at 100,003 rows (``front_equal_k3``,
   ``front_equal_k4``). K3's compress and combination in bf16 are the
   Hopper K3, entries of their own (``rowblock_fwd_sm90[<stage>]``) with
   the same checks, and whether the output equals the general body's bit
   for bit (reported, not gated); the same for the 2-part compress and at
   A x M rows for M = 64, 48 and 16 (A = 11,000) and at 100,003 rows under
   ``shapes``. ``rowblock_fwd[<stage>]`` keeps the general body in bf16
   (``sm90=False``), its launches the d_pet 256 calls'. The head is a
   stage of both (``rowblock_{fwd,bwd}_sm90[head]``, its weights resident
   in shared memory), with the same checks and shapes; its entries also
   report the shared bytes per block, and the Hopper K4 head's recompute
   of the forward (``rowblock.k4_sm90_head_front``) must equal the Hopper
   K3 head's output bit for bit at every shape (one ``head_front``: the
   served h and the backward's h0 round alike).
9. shapes: the C side's layout plans (shared bytes, workspace floats, row
   tiles) and the Hopper K1's, K2's, K3's and K4's dispatch rules and budgets,
   and the two-pass K2-dW's rule, chunk plan and slices, equal
   ``_lib``'s Python ones (the Hopper float32 K1's, K2's, K3's and K4's
   too) for M =
   16..256 and D of 64 to 256;
   K1, K2, K2-dW, the block's three kernels and, in bf16, K1-W8A8 and
   K2-W8A8 (the general bodies: under the Hopper pair's entries, keyed
   ``general_``) vs plain at M = 80, 96, 128 (D 128) and M = 64, 128 (D 256), A =
   256; K3, K4 and K4-dW at D = 256; the attention pair, K1, K2, K2-dW (and
   W8A8) at head widths 8, 12, 24 and 64; the bounds of phase 8, times under
   each entry's ``shapes``.

The second-to-last line is a JSON object with one entry per kernel (54);
the last line is ``{"ok": true, "device": {...}}``. Details also go to
``chiprun_out/chip_smoke.json``, the compiler's ``-Xptxas -v`` output to
``chiprun_out/chip_smoke_build.log``.
"""

from __future__ import annotations

import importlib.util
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
# the two-pass K2-dW's counters (its first pass, exact or int8 scores, and
# its product), launched 8 times a training step (4 layers, each in the
# forces' backward and in the loss's); the accumulate body's counters, which
# the training paths no longer launch
K2DW = ("fused_layer_bwd_dw_sm90", "layer_dw_product")
K2DW_INT8 = ("fused_layer_bwd_dw_int8_sm90", "layer_dw_product")
# in float32 at the served shapes (M <= 64, D = 128) the first pass is the
# Hopper float32 K2's spill mode
K2DW_F32 = ("fused_layer_bwd_dw_f32_sm90", "layer_dw_product")
K2DW_PER_STEP = 8
# what a float32 step at those shapes never launches: the accumulate body
# and the general body's first pass
K2DW_F32_NEVER = ("fused_layer_bwd_dw", "fused_layer_bwd_dw_sm90")
# the float32 compress, combination and head at d_part 128: the Hopper
# float32 K4 (2 + 2 + 1 a force call) and the two-pass K4-dW, its spill mode
# (4 + 4 + 2 a training step: 2 + 2 + 1 in the forces' backward and in the
# loss's) and its product (10); never the general body's
K4_F32 = ("rowblock_bwd_f32_sm90[compress]", "rowblock_bwd_f32_sm90[combination]",
          "rowblock_bwd_f32_sm90[head]")
K4_F32_PER_CALL = dict(zip(K4_F32, (2, 2, 1)))
K4DW_F32 = ("rowblock_bwd_dw_f32_sm90[compress]", "rowblock_bwd_dw_f32_sm90[combination]",
            "rowblock_bwd_dw_f32_sm90[head]", "rowblock_dw_product")
K4DW_F32_PER_STEP = dict(zip(K4DW_F32, (4, 4, 2, 10)))
# the Hopper float32 K1, at the served shapes the forward of every float32
# call and step (4 layers: 4 a force call, 4 a training step), with or
# without weight gradients; the general K1 then never
K1_F32 = "fused_layer_fwd_f32_sm90"
K1_F32_PER_STEP = 4
K4_GENERAL = ("rowblock_bwd[compress]", "rowblock_bwd[combination]", "rowblock_bwd[head]")
K4DW_GENERAL = ("rowblock_bwd_dw[compress]", "rowblock_bwd_dw[combination]", "rowblock_bwd_dw[head]")
K4_F32_NEVER = K4_GENERAL + K4DW_GENERAL
# the Hopper float32 K3, the forward of the float32 compress, combination
# and head at d_part 128 with or without weight gradients (2 + 2 + 1 a force
# call and a training step: its forward up to h, the head's up to pre1, is
# the f32 K4's and K4-dW's recompute); never the general K3 there
K3_F32 = ("rowblock_fwd_f32_sm90[compress]", "rowblock_fwd_f32_sm90[combination]",
          "rowblock_fwd_f32_sm90[head]")
K3_F32_PER_STEP = dict(zip(K3_F32, (2, 2, 1)))
K3_F32_NEVER = ("rowblock_fwd[compress]", "rowblock_fwd[combination]", "rowblock_fwd[head]")


def check_k2dw_launches(launches, kernels=K2DW_F32, never=K2DW_F32_NEVER, per_step=None):
    """The two-pass K2-dW's kernels launched (``per_step`` times each where
    given) and those of ``never`` (the accumulate body; in float32 also the
    general body's first pass) not at all."""
    counts = {k: launches.get(k, 0) for k in kernels}
    ran = {k: launches[k] for k in never if launches.get(k, 0)}
    if (not all(counts.values()) or ran
            or (per_step is not None and set(counts.values()) != {per_step})):
        fail(f"K2-dW launches {counts}, {ran}: expected {per_step or 'some'} each and none of "
             f"{never}")


def check_k4dw_launches(launches, steps=None):
    """The float32 row blocks of a training run: the two-pass K4-dW's kernels
    and the Hopper float32 K3 launched (``steps`` x K4DW_F32_PER_STEP and
    K3_F32_PER_STEP times each where given) and the general body's compress
    and combination, forward and backward, not at all."""
    per_step = K4DW_F32_PER_STEP | K3_F32_PER_STEP
    counts = {k: launches.get(k, 0) for k in per_step}
    never = K4_F32_NEVER + K3_F32_NEVER
    ran = {k: launches[k] for k in never if launches.get(k, 0)}
    if (not all(counts.values()) or ran or (
            steps is not None and counts != {k: n * steps for k, n in per_step.items()})):
        fail(f"K4-dW and float32 K3 launches {counts}, {ran}: expected "
             f"{'some' if steps is None else {k: n * steps for k, n in per_step.items()}} "
             f"and none of {never}")


def check_rowblock_f32_call(key, f32_call, general=False):
    """One f32 force call's row-block stages: the Hopper float32 K3
    (``K3_F32``) and K4 (``K4_F32``) 2 + 2 + 1 times each (compress,
    combination, head) and the general K3's and K4's never, or with
    ``general`` (d_pet 256) the reverse."""
    hopper = K3_F32_PER_STEP | K4_F32_PER_CALL
    bodies = dict(zip(K3_F32_NEVER + K4_GENERAL, hopper.values()))
    want, never = (bodies, hopper) if general else (hopper, bodies)
    if {k: f32_call.get(k, 0) for k in want} != want or any(f32_call.get(k, 0) for k in never):
        fail(f"{key}: the f32 force call launched {f32_call}: {want} and none of "
             f"{sorted(never)} expected")


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


# the int8-score kernels against the exact mode, per output: the kernel's
# relative RMS from its int8 plain version under this share of the int8
# plain version's distance from the exact one, and the share of that step
# which the kernel takes within this much of 1
INT8_MODE_SHARE, INT8_MODE_ALIGN = 0.5, 0.2


def compare_int8_mode(kernel_outs, int8_outs, exact_outs):
    """Tell the int8-score mode from the exact one, which the 2e-2 bound of
    :func:`compare` cannot (the int8 plain version lies about 5e-3 to 2e-2
    relative RMS from the exact one): per output, ``rel_int8`` (kernel vs
    int8 plain) must stay under ``INT8_MODE_SHARE`` x ``mode_distance``
    (int8 plain vs exact plain), and ``alignment`` = <k - x, i - x> /
    |i - x|^2, the share of the int8 mode's step that the kernel takes,
    within ``INT8_MODE_ALIGN`` of 1: a kernel on the exact scores gives
    about 0, one that quantizes half the way about 0.5. Returns the
    readings (``rel_exact`` too: kernel vs exact plain); raises when either
    gate fails."""
    readings = {"rel_int8": [], "rel_exact": [], "mode_distance": [], "alignment": []}
    for k, i, x in zip(kernel_outs, int8_outs, exact_outs):
        k, i, x = k.double(), i.double(), x.double()
        step, norm = i - x, i.pow(2).mean().sqrt().clamp_min(1e-30)
        dist = step.pow(2).mean().sqrt().item() / norm.item()
        readings["rel_int8"].append((k - i).pow(2).mean().sqrt().item() / norm.item())
        readings["rel_exact"].append((k - x).pow(2).mean().sqrt().item() / norm.item())
        readings["mode_distance"].append(dist)
        readings["alignment"].append(
            ((k - x) * step).sum().item() / max(step.pow(2).sum().item(), 1e-300))
        del k, i, x, step
    for rel, dist, align in zip(readings["rel_int8"], readings["mode_distance"],
                                readings["alignment"]):
        if not (rel < INT8_MODE_SHARE * dist and abs(align - 1.0) <= INT8_MODE_ALIGN):
            fail(f"int8-score kernel does not follow the int8 mode: {readings}")
    return readings


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
# tensor cores, bfloat16 and int8 on them
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_INT8_OPS_PER_S = 1979e12
# float32 products on the TF32 tensor cores as three products each (3xTF32:
# a_hi b_hi + a_hi b_lo + a_lo b_hi), 495 TFLOP/s dense TF32
PEAK_3XTF32_OPS_PER_S = 495e12 / 3


def record_bound(entry, tag, nbytes, flops, dtype, int8_ops=0, peak=None):
    """The least time the card could take for ``nbytes`` moved and
    ``flops`` (in ``dtype``, or at ``peak`` operations a second) plus
    ``int8_ops`` done: the larger of the bytes' time and the operations'
    time over their peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / (peak or PEAK_OPS_PER_S[dtype]) + int8_ops / PEAK_INT8_OPS_PER_S) * 1e3
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


def check_k2dw_entry(entry, tag, e, c, cf, w, ge, gc, H, scale, int8_scales=None):
    """The two-pass K2-dW's extras at one shape into ``entry``: the rule's
    kernels ran; its input gradients equal, bit for bit, those of the body
    its first pass runs: the Hopper float32 K2's (float32 at its shapes;
    the accumulate body, ``sm90=False``, then within the float32 bound of
    ``layer_bwd_math``) or the accumulate body's; that body's weight
    gradients within the weight-gradient bounds of its own and its time
    (``general_ms``); the bytes of its spill, partials and workspace; and
    its second pass alone (``layer_dw_product_cuda``) on one chunk of rows
    against ``dw_from_operands`` at the same bounds, both timed
    (``product_ms``, ``product_plain_ms``, per chunk of ``chunk_atoms``)."""
    from metatrain_tpu_torch.ops.kernels import _lib
    from metatrain_tpu_torch.ops.kernels import fused_layer as fl

    A, M, D = e.shape
    F = w.w_ffn_out.shape[0]
    kw = dict(weight_grads=True, int8_scales=int8_scales)
    hopper_f32 = int8_scales is None and _lib.k2_f32_sm90_takes(e.dtype, M, D, H, F, True)
    counter = K2DW_INT8[0] if int8_scales is not None else K2DW_F32[0] if hopper_f32 else K2DW[0]
    before = _lib.LAUNCHES[counter]
    k_out = fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale, **kw)
    ran = _lib.LAUNCHES[counter] > before
    if ran != _lib.k2dw_sm90_takes(e.dtype, M, D, H, F, int8_scales is not None):
        fail(f"K2-dW {e.dtype} at M={M}, D={D}: the two-pass kernels ran: {ran}, the rule says "
             "otherwise")
    general = lambda: fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale, sm90=False, **kw)  # noqa: E731
    g_out = general()
    torch.cuda.synchronize()
    if hopper_f32:
        same = fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(k_out[:3], same)):
            fail("the two-pass K2-dW's input gradients differ from the Hopper float32 K2's")
        entry[f"inputs_equal_hopper_f32_k2_{tag}"] = True
        entry[f"general_inputs_bound_ratio_{tag}"] = compare(
            g_out[:3], fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale), e.dtype)[1]
        del same
    else:
        if not all(torch.equal(a, b) for a, b in zip(k_out[:3], g_out[:3])):
            fail("the two-pass K2-dW's input gradients differ from the accumulate body's")
        entry[f"inputs_equal_general_{tag}"] = True
    entry[f"general_dw_vs_two_pass_ratio_{tag}"] = compare_dw(g_out[3], k_out[3], e.dtype)[1]
    del k_out, g_out
    entry[f"general_ms_{tag}"] = cuda_ms(general, 3)
    entry[f"workspace_bytes_{tag}"] = fl.k2dw_workspace_bytes(e, H, F, int8_scales is not None)
    plan = _lib.k2dw_plan(e.element_size(), A, M, D, F, _lib.sm_count(e.device))
    n = plan.chunk_atoms
    sub = [x[:n] for x in (e, c, cf, ge, gc)] + [None if int8_scales is None else int8_scales[:n]]
    ops = fl.layer_dw_operands(*sub[:3], w, *sub[3:5], H, scale, int8_scales=sub[5])
    one = _lib.k2dw_plan(e.element_size(), n, M, D, F, plan.sms, cap=1 << 62)
    spill, vectors = fl.pack_dw_operands(ops)
    k_dw = fl.layer_dw_product_cuda(spill, vectors, sub[3], plan.sms)
    p_dw = fl.dw_from_operands(ops, sub[3], one)
    torch.cuda.synchronize()
    err, worst = compare_dw(k_dw, p_dw, e.dtype)
    entry[f"product_max_abs_err_{tag}"] = err
    entry[f"product_bound_ratio_{tag}"] = worst
    entry[f"product_ms_{tag}"] = cuda_ms(
        lambda: fl.layer_dw_product_cuda(spill, vectors, sub[3], plan.sms))
    entry[f"product_plain_ms_{tag}"] = cuda_ms(lambda: fl.dw_from_operands(ops, sub[3], one), 2)
    entry[f"chunks_{tag}"], entry[f"chunk_atoms_{tag}"] = plan.chunks, plan.chunk_atoms
    del ops, spill, vectors
    torch.cuda.empty_cache()


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
    # products per layer: the dense ones over A * M rows and the attention;
    # a backward recomputes the forward but its FFN-out product, which no
    # gradient needs
    dense = A * M * (8 * D * D + 6 * D * F)
    ffn_out = 2 * A * M * D * F
    attention = 4 * A * H * M * M * (D // H)
    n_weights = sum(x.numel() for x in w)
    for dtype in (torch.float32, torch.bfloat16):
        s_ = torch.tensor([], dtype=dtype).element_size()
        act = A * M * D * s_ + A * D * s_  # one (edges, center) pair
        for name, nbytes, flops in (
            ("fused_layer_fwd", 2 * act + A * M * 4 + n_weights * s_, dense + attention),
            ("fused_layer_bwd", 4 * act + 2 * A * M * 4 + n_weights * s_,
             2 * dense - ffn_out + 3 * attention),
            ("fused_layer_bwd_dw", 4 * act + 2 * A * M * 4 + n_weights * (s_ + 4),
             3 * dense - ffn_out + 3 * attention),
        ):
            entry = report.setdefault(name, {"library_ms": None})
            record_bound(entry, "f32" if dtype == torch.float32 else "bf16", nbytes, flops, dtype)
            if name == "fused_layer_fwd":  # the Hopper K1 computes the same function
                k1_bound = (nbytes, flops, dtype)
            if name == "fused_layer_bwd":  # and the Hopper float32 K2
                k2_bound = (nbytes, flops)
        e, c, ge, gc = (x.to(dtype) for x in (edges, center, g_edge, g_center))
        before_k1 = fl._lib.LAUNCHES["fused_layer_fwd_sm90"]
        before_k1_f32 = fl._lib.LAUNCHES[K1_F32]
        fwd_k = fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale)
        fwd_p = fl.layer_math(e, c, cf, w, H, scale)
        before = fl._lib.LAUNCHES["fused_layer_bwd_sm90"]
        bwd_k = fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale)
        bwd_p = fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale)
        torch.cuda.synchronize()
        tag = "f32" if dtype == torch.float32 else "bf16"
        # which K1 and K2 ran: the Hopper ones take the served bf16 shape
        k1_sm90 = fl._lib.LAUNCHES["fused_layer_fwd_sm90"] > before_k1
        if k1_sm90 != fl._lib.k1_sm90_takes(dtype, M, D, H, F):
            fail(f"K1 {dtype} at M={M}: the Hopper kernel ran: {k1_sm90}, the rule says otherwise")
        k1_f32 = fl._lib.LAUNCHES[K1_F32] > before_k1_f32
        if k1_f32 != fl._lib.k1_f32_sm90_takes(dtype, M, D, H, F):
            fail(f"K1 {dtype} at M={M}: the Hopper float32 K1 ran: {k1_f32}, the rule says "
                 "otherwise")
        sm90 = fl._lib.LAUNCHES["fused_layer_bwd_sm90"] > before
        if sm90 != fl._lib.k2_sm90_takes(dtype, M, D, H, F):
            fail(f"K2 {dtype} at M={M}: the Hopper kernel ran: {sm90}, the rule says otherwise")
        report.setdefault("fused_layer_bwd", {})[f"kernel_{tag}"] = (
            "fused_layer_bwd_sm90" if sm90 else "fused_layer_bwd")
        if sm90:
            check_k2_sm90_entry(report["fused_layer_bwd"], e, c, cf, w, ge, gc, H, scale, bwd_k,
                                bwd_p)
        k2_f32 = fl._lib.k2_f32_sm90_takes(dtype, M, D, H, F)
        if k2_f32:
            # the Hopper float32 K2: an entry of its own; K2's entry keeps the
            # general body in float32
            check_f32_sm90_entry(
                report, "fused_layer_bwd_f32_sm90",
                lambda **kw: fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale, **kw),
                lambda: fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale), bwd_k, bwd_p, k2_bound)
            bwd_k = fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale, sm90=False)
        general = lambda: fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale, sm90=False)  # noqa: E731
        # K1's entry keeps the general body where a Hopper K1 took the call
        fwd_checks = [("fused_layer_fwd", general() if k1_sm90 or k1_f32 else fwd_k, fwd_p, general,
                       lambda: fl.layer_math(e, c, cf, w, H, scale))]
        if k1_f32:
            check_f32_sm90_entry(
                report, K1_F32, lambda **kw: fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale, **kw),
                lambda: fl.layer_math(e, c, cf, w, H, scale), fwd_k, fwd_p, k1_bound[:2])
        if k1_sm90:
            k1_entry = report.setdefault("fused_layer_fwd_sm90", {"library_ms": None})
            record_bound(k1_entry, tag, *k1_bound)
            check_k1_sm90_entry(k1_entry, e, c, cf, w, H, scale, fwd_k, fwd_p)
            fwd_checks.append(("fused_layer_fwd_sm90", fwd_k, fwd_p,
                               lambda: fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale),
                               lambda: fl.layer_math(e, c, cf, w, H, scale)))
        for name, k_out, p_out, k_fn, p_fn in (
            *fwd_checks,
            ("fused_layer_bwd", bwd_k, bwd_p,
             lambda: fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale, sm90=not k2_f32),
             lambda: fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale)),
        ):
            err, worst = compare(k_out, p_out, dtype)
            entry = report.setdefault(name, {})
            entry[f"max_abs_err_{tag}"] = err
            entry[f"bound_ratio_{tag}"] = worst
            entry[f"ms_{tag}"] = cuda_ms(k_fn)
            entry[f"plain_ms_{tag}"] = cuda_ms(p_fn)
        del fwd_k, fwd_p, bwd_k, bwd_p, fwd_checks
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
        check_k2dw_entry(report["fused_layer_bwd_dw"], tag, e, c, cf, w, ge, gc, H, scale)


def ptxas_usage(log: str, kernel: str):
    """Registers and spill bytes that ``-Xptxas -v`` reported for the
    entry functions whose names contain ``kernel``."""
    import re

    found = []
    for block in log.split("Compiling entry function")[1:]:
        name = block.split("'")[1] if "'" in block else ""
        if kernel not in name:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        found.append({"registers": int(regs.group(1)) if regs else None,
                      "spill_stores": int(spills.group(1)) if spills else None,
                      "spill_loads": int(spills.group(2)) if spills else None})
    return found


def check_k2_sm90_entry(entry, e, c, cf, w, ge, gc, H, scale, k_out, p_out):
    """The Hopper K2's extras at one shape into ``entry``: d_cf bitwise
    equal across two launches, the general body (``sm90=False``) against
    the same twin and its time."""
    from metatrain_tpu_torch.ops.kernels import fused_layer as fl

    again = fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale)
    torch.cuda.synchronize()
    if not torch.equal(k_out[2], again[2]):
        fail("the Hopper K2 gave different d_cf in two launches")
    entry["bitwise_dcf_repeat_bf16"] = True
    entry["bitwise_repeat_all_bf16"] = all(torch.equal(a, b) for a, b in zip(k_out, again))
    general = lambda: fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale, sm90=False)  # noqa: E731
    _, worst = compare(general(), p_out, torch.bfloat16)
    entry["general_bound_ratio_bf16"] = worst
    entry["general_ms_bf16"] = cuda_ms(general)


def check_f32_sm90_entry(report, name, launch, plain, k_out, p_out, bound):
    """A Hopper float32 kernel (``name``: ``fused_layer_fwd_f32_sm90`` or
    ``fused_layer_bwd_f32_sm90``) at the served shape
    (``check_f32_sm90_shape``), its plain version's ms and its bound at the
    3xTF32 tensor-core peak (``bound_ms``) and on the FFMA pipes
    (``bound_ms_ffma``)."""
    entry = report.setdefault(name, {"library_ms": None})
    for key, value in check_f32_sm90_shape(name, launch, k_out, p_out).items():
        entry[f"{key}_f32"] = value
    record_bound(entry, "f32", *bound, torch.float32, peak=PEAK_3XTF32_OPS_PER_S)
    ffma = {}
    record_bound(ffma, "f32", *bound, torch.float32)
    entry["bound_ms_ffma_f32"] = ffma["bound_ms_f32"]
    entry["plain_ms_f32"] = cuda_ms(plain)


def check_f32_sm90_shape(name, launch, k_out, p_out):
    """A Hopper float32 kernel's checks at one shape (``launch(**kw)`` its
    wrapper on the shape's inputs, ``k_out`` from the default path, ``p_out``
    the plain version's): max |kernel - plain| <= 1e-4 max |plain|, every
    output bitwise equal across two launches, CUDA-event ms beside the
    general body's (``sm90=False``, ``general_ms``, itself held to the same
    bound)."""
    err, worst = compare(k_out, p_out, torch.float32)
    again = launch()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k_out, again)):
        fail(f"{name} gave different outputs in two launches")
    del again
    general = lambda: launch(sm90=False)  # noqa: E731
    return {"max_abs_err": err, "bound_ratio": worst, "bitwise_repeat": True,
            "general_bound_ratio": compare(general(), p_out, torch.float32)[1],
            "ms": cuda_ms(launch), "general_ms": cuda_ms(general)}


def check_k1_sm90_entry(entry, e, c, cf, w, H, scale, k_out, p_out):
    """The Hopper K1's extras at one shape into ``entry``: both outputs
    bitwise equal across two launches, the general body (``sm90=False``)
    against the same twin and its time."""
    from metatrain_tpu_torch.ops.kernels import fused_layer as fl

    again = fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k_out, again)):
        fail("the Hopper K1 gave different outputs in two launches")
    entry["bitwise_repeat_bf16"] = True
    general = lambda: fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale, sm90=False)  # noqa: E731
    _, worst = compare(general(), p_out, torch.bfloat16)
    entry["general_bound_ratio_bf16"] = worst
    entry["general_ms_bf16"] = cuda_ms(general)


def check_sm90_shapes(gen, device, report, D=128, H=8, F=256):
    """The Hopper K1 and K2 against their twins beyond the served shape: M =
    64, 48 and 16 at A = 11,000 (any atom count: one block per atom or per
    pair of atoms) and M = 32 at A = 1,000; bf16 relative RMS <= 2e-2, K1's
    outputs and K2's d_cf bitwise equal across two launches, CUDA-event ms
    beside the general bodies', under each entry's ``shapes``; the Hopper
    float32 K1 and K2 at the same shapes with their own checks
    (``check_f32_sm90_shape``)."""
    from metatrain_tpu_torch.ops.kernels import fused_layer as fl

    for A, M in ((11000, 64), (11000, 48), (11000, 16), (1000, 32)):
        edges, center, cf, w, g_edge, g_center = layer_case(A, M, D, H, F, gen, device)
        e, c, ge, gc = (x.to(torch.bfloat16) for x in (edges, center, g_edge, g_center))
        scale = 1.0 / math.sqrt(D // H)
        before = fl._lib.LAUNCHES["fused_layer_fwd_sm90"]
        k_out = fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale)
        torch.cuda.synchronize()
        if fl._lib.LAUNCHES["fused_layer_fwd_sm90"] != before + 1:
            fail(f"the Hopper K1 did not take A={A}, M={M}")
        p_out = fl.layer_math(e, c, cf, w, H, scale)
        err, worst = compare(k_out, p_out, torch.bfloat16)
        sub = {}
        check_k1_sm90_entry(sub, e, c, cf, w, H, scale, k_out, p_out)
        sub.update(max_abs_err=err, bound_ratio=worst,
                   ms=cuda_ms(lambda: fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale)))
        report.setdefault("fused_layer_fwd_sm90", {}).setdefault("shapes", {})[
            f"A{A}_M{M}_bf16"] = sub
        del k_out, p_out
        before = fl._lib.LAUNCHES["fused_layer_bwd_sm90"]
        k_out = fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale)
        torch.cuda.synchronize()
        if fl._lib.LAUNCHES["fused_layer_bwd_sm90"] != before + 1:
            fail(f"the Hopper K2 did not take A={A}, M={M}")
        p_out = fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale)
        err, worst = compare(k_out, p_out, torch.bfloat16)
        sub = {}
        check_k2_sm90_entry(sub, e, c, cf, w, ge, gc, H, scale, k_out, p_out)
        sub.update(max_abs_err=err, bound_ratio=worst,
                   ms=cuda_ms(lambda: fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale)))
        report.setdefault("fused_layer_bwd", {}).setdefault("shapes", {})[
            f"sm90_A{A}_M{M}_bf16"] = sub
        del k_out, p_out, e, c, ge, gc
        before = fl._lib.LAUNCHES[K1_F32]
        k_out = fl.fused_layer_fwd_cuda(edges, center, cf, w, H, scale)
        torch.cuda.synchronize()
        if fl._lib.LAUNCHES[K1_F32] != before + 1:
            fail(f"the Hopper float32 K1 did not take A={A}, M={M}")
        p_out = fl.layer_math(edges, center, cf, w, H, scale)
        report.setdefault(K1_F32, {}).setdefault("shapes", {})[f"A{A}_M{M}_f32"] = (
            check_f32_sm90_shape(
                K1_F32, lambda **kw: fl.fused_layer_fwd_cuda(edges, center, cf, w, H, scale, **kw),
                k_out, p_out))
        del k_out, p_out
        before = fl._lib.LAUNCHES["fused_layer_bwd_f32_sm90"]
        k_out = fl.fused_layer_bwd_cuda(edges, center, cf, w, g_edge, g_center, H, scale)
        torch.cuda.synchronize()
        if fl._lib.LAUNCHES["fused_layer_bwd_f32_sm90"] != before + 1:
            fail(f"the Hopper float32 K2 did not take A={A}, M={M}")
        p_out = fl.layer_bwd_math(edges, center, cf, w, g_edge, g_center, H, scale)
        report.setdefault("fused_layer_bwd_f32_sm90", {}).setdefault("shapes", {})[
            f"A{A}_M{M}_f32"] = check_f32_sm90_shape(
                "fused_layer_bwd_f32_sm90",
                lambda **kw: fl.fused_layer_bwd_cuda(edges, center, cf, w, g_edge, g_center, H, scale,
                                                     **kw),
                k_out, p_out)
        del k_out, p_out
        torch.cuda.empty_cache()


def check_w8a8_layer(A, M, D, H, F, gen, device, report, tag=None):
    """K1-W8A8 and K2-W8A8 vs their plain versions (bfloat16, a calibration
    from the plain probe on the same inputs) at (A, M): the Hopper pair
    (``W8A8_SM90``: the W8A8 mode of the Hopper K1 and K2; each bitwise on a
    repeat) and the general bodies through ``sm90=False`` (the entries'
    ``general_*``), relative RMS <= 2e-2 per output and told from the exact
    mode (:func:`compare_int8_mode` against ``layer_math`` /
    ``layer_bwd_math`` without ``w8a8``: a kernel whose dense products
    stayed bf16 fails it), with CUDA-event times and bounds (the int8
    products at 1,979 TOPS, the bf16 ones at 989 TFLOP/s). ``tag`` keys a
    second shape's numbers under ``shapes`` instead of the entries' own."""
    from metatrain_tpu_torch.ops.kernels import fused_layer as fl

    edges, center, cf, w, g_edge, g_center = layer_case(A, M, D, H, F, gen, device)
    e, c, ge, gc = (x.to(torch.bfloat16) for x in (edges, center, g_edge, g_center))
    scale = 1.0 / math.sqrt(D // H)
    calib = fl.Int8Calib.from_stats(fl.layer_probe_stats(e, c, cf, w, H, scale).tolist(), w)
    w8a8 = (calib, fl.quantize_layer_weights(w, calib))
    # products per atom (2 operations per multiply-add): int8 QKV, scores,
    # FFN-in and FFN-out; bf16 AV and out-projection; the backward
    # recomputes all but FFN-out, then runs eight bf16 products
    qkv, ffn_in, ffn_out = 2 * M * D * 3 * D, 2 * M * D * 2 * F, 2 * M * F * D
    head, out = 2 * H * M * M * (D // H), 2 * M * D * D
    # bytes: activations in bf16, cf and d_cf in f32, the bf16 weights and
    # the int8 ones each kernel reads (K2-W8A8 does not read FFN-out's)
    n_w, n_i8 = sum(x.numel() for x in w), 3 * D * D + 2 * D * F
    act = A * M * D * 2 + A * D * 2
    sizes = {
        W8A8_SM90[0]: (2 * act + A * M * 4 + n_w * 2 + n_i8 + F * D,
                       A * (head + out), A * (qkv + head + ffn_in + ffn_out)),
        W8A8_SM90[1]: (4 * act + 2 * A * M * 4 + n_w * 2 + n_i8,
                       A * (5 * head + 2 * out + ffn_out + ffn_in + qkv),
                       A * (qkv + head + ffn_in)),
    }

    def k1(**kw):
        return fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale, w8a8=w8a8, **kw)

    def k2(**kw):
        return fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale, w8a8=w8a8, **kw)

    cases = (  # (entry, launch, plain, exact plain)
        (W8A8_SM90[0], k1, lambda: fl.layer_math(e, c, cf, w, H, scale, w8a8=w8a8),
         lambda: fl.layer_math(e, c, cf, w, H, scale)),
        (W8A8_SM90[1], k2, lambda: fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale, w8a8=w8a8),
         lambda: fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale)),
    )
    lib = fl._lib.library()
    for name, k_fn, p_fn, x_fn in cases:
        before = fl._lib.LAUNCHES[name]
        k_out, p_out, x_out = k_fn(), p_fn(), x_fn()
        torch.cuda.synchronize()
        if fl._lib.LAUNCHES[name] != before + 1:
            fail(f"{name} at A={A}, M={M} did not launch")
        err, worst = compare(k_out, p_out, torch.bfloat16)
        entry = {"max_abs_err_bf16": err, "bound_ratio_bf16": worst,
                 "int8_mode_bf16": compare_int8_mode(k_out, p_out, x_out)}
        again = k_fn()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(k_out, again)):
            fail(f"{name} gave different outputs in two launches")
        entry["bitwise_repeat_bf16"] = True
        del again
        general = lambda: k_fn(sm90=False)  # noqa: E731
        g_out = general()
        entry["general_bound_ratio_bf16"] = compare(g_out, p_out, torch.bfloat16)[1]
        entry["general_int8_mode_bf16"] = compare_int8_mode(g_out, p_out, x_out)
        del g_out, k_out, p_out, x_out
        torch.cuda.empty_cache()
        entry.update(ms_bf16=cuda_ms(k_fn), general_ms_bf16=cuda_ms(general),
                     plain_ms_bf16=cuda_ms(p_fn))
        entry["smem_bytes"] = getattr(lib, f"mtt_{name}_smem")(M, D, H, F)
        record_bound(entry, "bf16", *sizes[name][:2], torch.bfloat16, sizes[name][2])
        entry["library_ms"] = None
        if tag is None:
            report.setdefault(name, {}).update(entry)
        else:
            report.setdefault(name, {}).setdefault("shapes", {})[tag] = entry
        torch.cuda.empty_cache()


def check_int8_layer(A, M, D, H, F, gen, device, report, tag=None):
    """The dynamic int8 scores' kernels vs their plain versions (bfloat16):
    the absmax passes, general and Hopper (scales within one bf16 ulp of the
    plain version's; the Hopper pass bitwise on a repeat, the general
    pass's time as its ``general_ms``),
    K1-int8 and K2-int8, the Hopper pair (``INT8_SM90``; each bitwise on a
    repeat) and the general bodies through ``sm90=False`` (K1-int8's entry
    ``fused_layer_fwd_int8``, K2-int8's the Hopper K2-int8's
    ``general_ms``), and K2-dW-int8 (relative RMS <= 2e-2 per output) at
    (A, M), with CUDA-event times and bounds (the score products at 1,979
    TOPS, the rest at 989 TFLOP/s). K1-int8 and K2-int8, both bodies, must
    also be told from the exact mode (:func:`compare_int8_mode`, against
    ``layer_math`` / ``layer_bwd_math`` without scales). ``tag`` keys a second shape's numbers
    under ``shapes`` instead of the entries' own."""
    from metatrain_tpu_torch.ops.kernels import fused_layer as fl

    edges, center, cf, w, g_edge, g_center = layer_case(A, M, D, H, F, gen, device)
    e, c, ge, gc = (x.to(torch.bfloat16) for x in (edges, center, g_edge, g_center))
    scale = 1.0 / math.sqrt(D // H)
    BA = fl.int8_block_atoms(M)
    k_blocks = fl.int8_absmax_cuda(e, c, w, BA)
    h_blocks = fl.int8_absmax_sm90_cuda(e, c, w, H, BA)
    p_blocks = fl.int8_block_scales(e, c, w, BA)
    torch.cuda.synchronize()
    # one bf16 ulp of the absmax (2^-7 relative), the scales' quotient by
    # 127: both passes form q and k in another order than the plain version
    ulps = {}
    for name, blocks in (("int8_absmax", k_blocks), ("int8_absmax_sm90", h_blocks)):
        ulps[name] = ((blocks - p_blocks).abs() / (p_blocks.abs() * 2.0 ** -7)).max().item()
        if not ulps[name] <= 1.0:
            fail(f"{name} scales differ from the plain version's by {ulps[name]:.3g} bf16 ulps")
    scales = fl.int8_atom_scales(k_blocks, A, BA)
    qkv, ffn, head, out = 2 * M * D * 3 * D, 2 * M * D * 3 * F, 2 * H * M * M * (D // H), \
        2 * M * D * D
    ffn_out = 2 * M * F * D  # the backward's recompute skips it
    n_w = sum(x.numel() for x in w)
    act = A * M * D * 2 + A * D * 2
    fwd_size = (2 * act + A * M * 4 + A * 8 + n_w * 2, A * (qkv + head + out + ffn), A * head)
    # both passes: edge rows 0 .. M - 2 and the center (K1's rows), the q
    # and k columns of w_qkv, the scales
    absmax_bytes = A * (M - 1) * D * 2 + A * D * 2 + 2 * D * D * 2 + 8 * -(-A // BA)
    sizes = {  # bytes, bf16 flops, int8 ops
        "int8_absmax": (absmax_bytes, A * 2 * qkv // 3, 0),
        "int8_absmax_sm90": (absmax_bytes, A * 2 * qkv // 3, 0),
        "fused_layer_fwd_int8": fwd_size,
        "fused_layer_fwd_int8_sm90": fwd_size,
        "fused_layer_bwd_int8_sm90": (4 * act + 2 * A * M * 4 + A * 8 + n_w * 2,
                                      A * (2 * qkv + 5 * head + 2 * out + 2 * ffn - ffn_out),
                                      A * head),
        "fused_layer_bwd_dw_int8": (4 * act + 2 * A * M * 4 + A * 8 + n_w * 6,
                                    A * (3 * qkv + 5 * head + 3 * out + 3 * ffn - ffn_out),
                                    A * head),
    }

    def k1(**kw):
        return fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale, int8_scales=scales, **kw)

    def k2(**kw):
        return fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale, int8_scales=scales, **kw)

    def k1_plain():
        return fl.layer_math(e, c, cf, w, H, scale, int8_scales=scales)

    def k2_plain():
        return fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale, int8_scales=scales)

    def k1_exact():
        return fl.layer_math(e, c, cf, w, H, scale)

    def k2_exact():
        return fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale)

    # (entry, its launch, the counter it must add one to, plain version,
    # the exact plain version the int8 mode must be told from); the general
    # K2-int8 runs on no path, so it stands as the Hopper K2-int8's general_*
    cases = (
        ("int8_absmax", lambda: (fl.int8_absmax_cuda(e, c, w, BA),), "int8_absmax",
         lambda: (fl.int8_block_scales(e, c, w, BA),), None),
        ("int8_absmax_sm90", lambda: (fl.int8_absmax_sm90_cuda(e, c, w, H, BA),),
         "int8_absmax_sm90", lambda: (fl.int8_block_scales(e, c, w, BA),), None),
        ("fused_layer_fwd_int8", lambda: k1(sm90=False), "fused_layer_fwd_int8", k1_plain,
         k1_exact),
        ("fused_layer_fwd_int8_sm90", k1, INT8_SM90[0], k1_plain, k1_exact),
        ("fused_layer_bwd_int8_sm90", k2, INT8_SM90[1], k2_plain, k2_exact),
    )
    results = {}
    for name, k_fn, counter, p_fn, x_fn in cases:
        before = fl._lib.LAUNCHES[counter]
        k_out, p_out = k_fn(), p_fn()
        torch.cuda.synchronize()
        if fl._lib.LAUNCHES[counter] != before + 1:
            fail(f"{name} at A={A}, M={M} did not launch {counter}")
        err, worst = compare(k_out, p_out, torch.bfloat16)
        entry = {"max_abs_err_bf16": err, "bound_ratio_bf16": worst}
        x_out = x_fn() if x_fn else None
        if x_out is not None:
            entry["int8_mode_bf16"] = compare_int8_mode(k_out, p_out, x_out)
        if counter in (*INT8_SM90, "int8_absmax_sm90"):
            again = k_fn()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(k_out, again)):
                fail(f"{counter} gave different outputs in two launches")
            entry["bitwise_repeat_bf16"] = True
            del again
        if counter == "int8_absmax_sm90":  # the general pass beside it
            entry["general_ms_bf16"] = cuda_ms(cases[0][1])
        elif counter in INT8_SM90:
            general = lambda: k_fn(sm90=False)  # noqa: E731
            g_out = general()
            entry["general_bound_ratio_bf16"] = compare(g_out, p_out, torch.bfloat16)[1]
            entry["general_int8_mode_bf16"] = compare_int8_mode(g_out, p_out, x_out)
            del g_out
            entry["general_ms_bf16"] = cuda_ms(general)
        del k_out, p_out, x_out
        entry.update(ms_bf16=cuda_ms(k_fn), plain_ms_bf16=cuda_ms(p_fn))
        results[name] = entry
        torch.cuda.empty_cache()
    dw_report = {}
    check_dw(
        "fused_layer_bwd_dw_int8", "bf16", torch.bfloat16,
        lambda: (lambda o: (*o[:3], *o[3]))(fl.fused_layer_bwd_cuda(
            e, c, cf, w, ge, gc, H, scale, weight_grads=True, int8_scales=scales)),
        lambda: (lambda o: (*o[:3], *o[3]))(fl.layer_bwd_math(
            e, c, cf, w, ge, gc, H, scale, weight_grads=True, int8_scales=scales)),
        3, dw_report,
    )
    torch.cuda.empty_cache()
    check_k2dw_entry(dw_report["fused_layer_bwd_dw_int8"], "bf16", e, c, cf, w, ge, gc, H, scale,
                     scales)
    results.update(dw_report)
    for name, ulp in ulps.items():
        results[name]["scale_ulps_bf16"] = ulp
    lib = fl._lib.library()
    results["int8_absmax_sm90"]["smem_bytes"] = lib.mtt_int8_absmax_sm90_smem(M, D, H, F)
    results["fused_layer_fwd_int8_sm90"]["smem_bytes"] = lib.mtt_fused_layer_fwd_int8_sm90_smem(
        M, D, H, F)
    results["fused_layer_bwd_int8_sm90"]["smem_bytes"] = lib.mtt_fused_layer_bwd_int8_sm90_smem(
        M, D, H, F)
    for name, entry in results.items():
        record_bound(entry, "bf16", *sizes[name][:2], torch.bfloat16, sizes[name][2])
        entry["library_ms"] = None
        if tag is None:
            report.setdefault(name, {}).update(entry)
        else:
            report.setdefault(name, {}).setdefault("shapes", {})[tag] = entry
    torch.cuda.empty_cache()


# the shapes of the repairs: windows above 64 slots and d_pet 256 (the
# fused-layer kernels and the block), and head widths 8, 12, 24 and 64
# (K1/K2, the attention pair, W8A8 where D and F are multiples of 32)
WINDOW_SHAPES = [(80, 128, 8, 256), (96, 128, 8, 256), (128, 128, 8, 256), (64, 256, 8, 512),
                 (128, 256, 8, 512)]
HEAD_SHAPES = [(64, 128, 16, 256), (64, 96, 8, 192), (64, 192, 8, 384), (64, 256, 4, 512)]


def plan_table():
    """The C side's shared bytes and workspace floats of every planned
    kernel against ``_lib``'s Python plan, for M = 16..256 (step 16), D of
    64, 96, 128, 192 and 256 (F = 2D, heads of 16, d_node 2D), and the row
    blocks' tiles at their PET widths. Raises on any difference."""
    import ctypes

    from metatrain_tpu_torch.ops.kernels import _lib

    lib = _lib.library()
    checked = 0
    for D in (64, 96, 128, 192, 256):
        F, N, H = 2 * D, 2 * D, max(D // 16, 1)
        for M in range(16, 257, 16):
            fwd = _lib.layer_fwd_plan(M, D, F)
            pairs = [
                (_lib.plan_query(lib.mtt_fused_layer_fwd_smem, M, D, F),
                 (4 * fwd.smem_floats, fwd.ws_floats)),
                (_lib.plan_query(lib.mtt_gnn_block_fwd_smem, M, D, F, N),
                 _lib.gnn_block_sizes(M, D, H, F, N, False, False)),
            ]
            for dw in (0, 1):
                for query, q8 in ((lib.mtt_fused_layer_bwd_smem, False),
                                  (lib.mtt_fused_layer_bwd_int8_smem, True)):
                    b = _lib.layer_bwd_plan(M, D, H, F, bool(dw), q8)
                    pairs.append((_lib.plan_query(query, M, D, H, F, dw),
                                  (4 * b.smem_floats, b.ws_floats)))
                pairs.append((_lib.plan_query(lib.mtt_gnn_block_bwd_smem, M, D, H, F, N, dw),
                              _lib.gnn_block_sizes(M, D, H, F, N, bool(dw), True)))
            b = _lib.layer_bwd_plan(M, D, H, F, False, True)
            pairs.append((_lib.plan_query(lib.mtt_fused_layer_bwd_w8a8_smem, M, D, H, F),
                          (4 * b.smem_floats, b.ws_floats)))
            # the Hopper node-stream kernels' widths and budgets
            if M == 16:
                for Nn in range(64, 1025, 64):
                    for bwd in (0, 1):
                        pairs.append(((bool(lib.mtt_gnn_node_sm90_ok(Nn, D)),
                                       lib.mtt_gnn_node_sm90_smem(Nn, D, bwd)),
                                      (_lib.gnn_node_sm90_shape(Nn, D),
                                       _lib.gnn_node_sm90_smem(Nn, D, bool(bwd)))))
            # the Hopper K1's and K2's dispatch rules and budgets (bf16, its
            # int8-score and W8A8 modes, which take the exact mode's shapes,
            # and float32), C vs Python, at heads of 16 and of 8
            for heads in (H, 2 * H):
                for kind in ("fwd", "bwd"):
                    rule, budget = ((_lib.k1_sm90_takes, _lib.k1_sm90_smem) if kind == "fwd"
                                    else (_lib.k2_sm90_takes, _lib.k2_sm90_smem))
                    for mode in ("int8", "w8a8"):
                        pairs.append(((bool(getattr(lib, f"mtt_fused_layer_{kind}_sm90_ok")(
                                           M, D, heads, F)),
                                       getattr(lib, f"mtt_fused_layer_{kind}_{mode}_sm90_smem")(
                                           M, D, heads, F)),
                                      (rule(torch.bfloat16, M, D, heads, F, **{mode: True}),
                                       budget(M, D, heads, F, **{mode: True}))))
                pairs.append(((bool(lib.mtt_fused_layer_bwd_sm90_ok(M, D, heads, F)),
                               lib.mtt_fused_layer_bwd_sm90_smem(M, D, heads, F)),
                              (_lib.k2_sm90_takes(torch.bfloat16, M, D, heads, F),
                               _lib.k2_sm90_smem(M, D, heads, F))))
                pairs.append(((bool(lib.mtt_fused_layer_fwd_sm90_ok(M, D, heads, F)),
                               lib.mtt_fused_layer_fwd_sm90_smem(M, D, heads, F)),
                              (_lib.k1_sm90_takes(torch.bfloat16, M, D, heads, F),
                               _lib.k1_sm90_smem(M, D, heads, F))))
                # the Hopper absmax pass: the Hopper K1-int8's rule
                pairs.append(((bool(lib.mtt_int8_absmax_sm90_ok(M, D, heads, F)),
                               lib.mtt_int8_absmax_sm90_smem(M, D, heads, F)),
                              (_lib.absmax_sm90_takes(torch.bfloat16, M, D, heads, F),
                               _lib.absmax_sm90_smem(M, D, heads, F))))
                pairs.append(((bool(lib.mtt_fused_layer_bwd_f32_sm90_ok(M, D, heads, F)),
                               lib.mtt_fused_layer_bwd_f32_sm90_smem(M, D, heads, F)),
                              (_lib.k2_f32_sm90_takes(torch.float32, M, D, heads, F),
                               _lib.k2_f32_sm90_smem(M, D, heads, F))))
                pairs.append(((bool(lib.mtt_fused_layer_fwd_f32_sm90_ok(M, D, heads, F)),
                               lib.mtt_fused_layer_fwd_f32_sm90_smem(M, D, heads, F)),
                              (_lib.k1_f32_sm90_takes(torch.float32, M, D, heads, F),
                               _lib.k1_f32_sm90_smem(M, D, heads, F))))
            # the two-pass K2-dW's rule (both dtypes, int8 scores or not), its
            # chunk plan and its slices, C vs Python
            for heads in (H, 2 * H):
                for code, dt in ((0, torch.float32), (1, torch.bfloat16)):
                    for i8 in (0, 1):
                        pairs.append(((bool(lib.mtt_fused_layer_bwd_dw_sm90_ok(
                            code, M, D, heads, F, i8)),),
                            (_lib.k2dw_sm90_takes(dt, M, D, heads, F, bool(i8)),)))
            for elem in (4, 2):
                for atoms in (1, 7, 2048, 11392):
                    out = (ctypes.c_longlong * 5)()
                    lib.mtt_fused_layer_bwd_dw_sm90_plan(elem, atoms, M, D, F, 132, out)
                    pairs.append((tuple(out), _lib.k2dw_plan(elem, atoms, M, D, F, 132)[:5]))
            for rows in (M, 300 * M, 1140 * M):
                out = (ctypes.c_longlong * 2)()
                lib.mtt_layer_dw_slices(rows, D, F, 132, out)
                pairs.append((tuple(out), _lib.k2dw_slices(rows, D, F, 132)))
            for c_side, py_side in pairs:
                if tuple(c_side) != tuple(py_side):
                    fail(f"layout plan at M={M}, D={D}: C {c_side} != Python {py_side}")
                checked += 1
        # the Hopper K3's and K4's dispatch rules and budgets, C vs Python,
        # for every stage at d_part D, w_in of 1-4 parts, w_hid D or 2D,
        # w_out D or 128
        # (the float32 K3 and K4 in float32, and the two-pass K4-dW's plan)
        hopper_rowblocks = (
            ("K3", lib.mtt_rowblock_fwd_sm90_ok, lib.mtt_rowblock_fwd_sm90_smem,
             _lib.k3_sm90_takes, _lib.k3_sm90_smem, torch.bfloat16),
            ("K4", lib.mtt_rowblock_bwd_sm90_ok, lib.mtt_rowblock_bwd_sm90_smem,
             _lib.k4_sm90_takes, _lib.k4_sm90_smem, torch.bfloat16),
            ("float32 K4", lib.mtt_rowblock_bwd_f32_sm90_ok, lib.mtt_rowblock_bwd_f32_sm90_smem,
             _lib.k4_f32_sm90_takes, _lib.k4_f32_sm90_smem, torch.float32),
            ("float32 K3", lib.mtt_rowblock_fwd_f32_sm90_ok, lib.mtt_rowblock_fwd_f32_sm90_smem,
             _lib.k3_f32_sm90_takes, _lib.k3_f32_sm90_smem, torch.float32))
        for stage in (0, 1, 2):
            for w_in in range(D, 4 * D + 1, D):
                for w_hid in (D, 2 * D):
                    if stage < 2:
                        for rows in (1, 100003, 262144, 729088):
                            out = (ctypes.c_longlong * 5)()
                            lib.mtt_rowblock_bwd_dw_f32_sm90_plan(stage, rows, w_in, w_hid, D, 132,
                                                                  out)
                            py_side = _lib.k4dw_plan(stage, rows, w_in, w_hid, 132)[:5]
                            if tuple(out) != tuple(py_side):
                                fail(f"K4-dW plan at stage {stage}, {rows} rows, {w_in}/{w_hid}: "
                                     f"C {tuple(out)} != Python {py_side}")
                            checked += 1
                    for w_out in sorted({D, 128}):
                        for kernel, c_ok, c_smem, py_takes, py_smem, dt in hopper_rowblocks:
                            widths = (stage, D, w_in, w_hid, w_out)
                            c_side = (bool(c_ok(*widths)), c_smem(*widths))
                            py_side = (py_takes(dt, *widths), py_smem(*widths))
                            if c_side != py_side:
                                fail(f"Hopper {kernel} rule at stage {stage}, D={D}, "
                                     f"{w_in}/{w_hid}/{w_out}: C {c_side} != Python {py_side}")
                            checked += 1
        for stage, w_in, w_hid, w_out in ((0, 3 * D, D, D), (1, 2 * D, 2 * D, D), (2, D, D, D)):
            rows = ctypes.c_int(0)
            nbytes = lib.mtt_rowblock_fwd_smem(w_in, w_hid, ctypes.byref(rows))
            tile = _lib.rowblock_fwd_rows(w_in, w_hid)
            if (rows.value, nbytes) != (tile, 4 * tile * (w_in + w_hid)):
                fail(f"row block fwd tile at D={D}: C {rows.value} != Python {tile}")
            for dw in (0, 1):
                nbytes = lib.mtt_rowblock_bwd_smem(stage, w_in, w_hid, w_out, dw, ctypes.byref(rows))
                tile = _lib.rowblock_bwd_rows(stage, w_in, w_hid, w_out, bool(dw))
                want = 4 * _lib.rowblock_bwd_floats(stage, w_in, w_hid, w_out, bool(dw), tile)
                if (rows.value, nbytes) != (tile, want):
                    fail(f"row block bwd tile at D={D}: C {rows.value} != Python {tile}")
                checked += 1
    return {"plans_checked": checked}


def shape_entry(report, name, key, dtype, err, worst, ms, plain_ms):
    tag = "f32" if dtype == torch.float32 else "bf16"
    report.setdefault(name, {}).setdefault("shapes", {})[f"{key}_{tag}"] = {
        "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "bound_ratio": worst,
        "ms": ms, "plain_ms": plain_ms}


def check_layer_shapes_on_card(gen, device, report, A=256):
    """K1, K2, K2-dW, the GNN block's three kernels and (bf16) K1-W8A8 and
    K2-W8A8 vs their plain versions at the windows and widths of
    WINDOW_SHAPES and the head widths of HEAD_SHAPES, float32 and bfloat16,
    A atoms; errors at the existing bounds and CUDA-event ms under each
    entry's ``shapes``."""
    from metatrain_tpu_torch.ops.kernels import fused_layer as fl
    from metatrain_tpu_torch.ops.kernels import gnn_block as gb

    for M, D, H, F in WINDOW_SHAPES + HEAD_SHAPES:
        edges, center, cf, w, g_edge, g_center = layer_case(A, M, D, H, F, gen, device)
        scale = 1.0 / math.sqrt(D // H)
        key = f"M{M}_D{D}_H{H}"
        for dtype in (torch.float32, torch.bfloat16):
            e, c, ge, gc = (x.to(dtype) for x in (edges, center, g_edge, g_center))
            cases = [
                ("fused_layer_fwd", lambda: fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale),
                 lambda: fl.layer_math(e, c, cf, w, H, scale)),
                ("fused_layer_bwd",
                 lambda: fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale),
                 lambda: fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale)),
            ]
            if dtype == torch.bfloat16 and D % 32 == 0 and F % 32 == 0 and H % 2 == 0:
                calib = fl.Int8Calib.from_stats(
                    fl.layer_probe_stats(e, c, cf, w, H, scale).tolist(), w)
                w8a8 = (calib, fl.quantize_layer_weights(w, calib))
                # these shapes run the general W8A8 bodies: under the Hopper
                # pair's entries, keyed general_
                cases += [
                    (W8A8_SM90[0],
                     lambda: fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale, w8a8=w8a8),
                     lambda: fl.layer_math(e, c, cf, w, H, scale, w8a8=w8a8)),
                    (W8A8_SM90[1],
                     lambda: fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale, w8a8=w8a8),
                     lambda: fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale, w8a8=w8a8)),
                ]
            for name, k_fn, p_fn in cases:
                err, worst = compare(k_fn(), p_fn(), dtype)
                shape_entry(report, name, f"general_{key}" if name in W8A8_SM90 else key, dtype,
                            err, worst, cuda_ms(k_fn, 3), cuda_ms(p_fn, 2))
            sub = {}
            check_dw(
                "fused_layer_bwd_dw", "x", dtype,
                lambda: (lambda o: (*o[:3], *o[3]))(
                    fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale, weight_grads=True)),
                lambda: (lambda o: (*o[:3], *o[3]))(
                    fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale, weight_grads=True)),
                3, sub,
            )
            x = sub["fused_layer_bwd_dw"]
            shape_entry(report, "fused_layer_bwd_dw", key, dtype, x["max_abs_err_x"],
                        x["bound_ratio_x"], x["ms_x"], x["plain_ms_x"])
            torch.cuda.empty_cache()
        if (M, D, H, F) not in WINDOW_SHAPES:
            continue
        # the block: 2 layers with the node expansion (d_node = 2D)
        edges_b, node, cf_b, lws, cws, flat, g_edge_b, g_node = gnn_case(A, M, D, H, F, 2 * D, 2,
                                                                         gen, device)
        for dtype in (torch.float32, torch.bfloat16):
            e, n, ge, gn = (x.to(dtype) for x in (edges_b, node, g_edge_b, g_node))
            for name, k_fn, p_fn in (
                ("gnn_block_fwd",
                 lambda: gb.gnn_block_fwd_cuda(e, n, cf_b, flat, H, scale, 2, True, sm90=False),
                 lambda: gb.gnn_block_math(e, n, cf_b, lws, cws, H, scale, True)),
                ("gnn_block_bwd",
                 lambda: gb.gnn_block_bwd_cuda(e, n, cf_b, flat, ge, gn, H, scale, 2, True,
                                               sm90=False),
                 lambda: gb.gnn_block_bwd_math(e, n, cf_b, lws, cws, ge, gn, H, scale, True)),
            ):
                err, worst = compare(k_fn(), p_fn(), dtype)
                shape_entry(report, name, key, dtype, err, worst, cuda_ms(k_fn, 3),
                            cuda_ms(p_fn, 2))
            sub = {}
            check_dw(
                "gnn_block_bwd_dw", "x", dtype,
                lambda: (lambda o: (*o[:3], *o[3]))(
                    gb.gnn_block_bwd_cuda(e, n, cf_b, flat, ge, gn, H, scale, 2, True, True)),
                lambda: (lambda o: (*o[:3], *o[3]))(
                    gb.gnn_block_bwd_math(e, n, cf_b, lws, cws, ge, gn, H, scale, True, True)),
                3, sub,
            )
            x = sub["gnn_block_bwd_dw"]
            shape_entry(report, "gnn_block_bwd_dw", key, dtype, x["max_abs_err_x"],
                        x["bound_ratio_x"], x["ms_x"], x["plain_ms_x"])
            torch.cuda.empty_cache()


def check_wide_rowblocks(rows, D, gen, device, report):
    """K3, K4 and K4-dW at d_pet D (the combination's 2D x 2D stage takes
    tiles of 32 rows at D = 256) vs their plain versions, both dtypes."""
    from metatrain_tpu_torch.ops.kernels import rowblock as rb

    key = f"D{D}"
    for stage, inputs, weights in stage_cases(rows, D, gen, device):
        for dtype in (torch.float32, torch.bfloat16):
            xs = tuple(t.to(dtype) for t in inputs)
            g = torch.randn(rows, weights[-1].shape[0], generator=gen).to(device, dtype)
            name = f"{stage.name}{len(xs)}" if stage.name == "compress" else stage.name
            for kind, k_fn, p_fn in (
                ("fwd", lambda: (rb.rowblock_fwd_cuda(stage, xs, weights),),
                 lambda: (stage.math(xs, weights),)),
                ("bwd", lambda: rb.rowblock_bwd_cuda(stage, xs, weights, g),
                 lambda: stage.bwd(xs, weights, g)),
            ):
                err, worst = compare(k_fn(), p_fn(), dtype)
                shape_entry(report, f"rowblock_{kind}[{stage.name}]", f"{key}_{name}", dtype, err,
                            worst, cuda_ms(k_fn, 3), cuda_ms(p_fn, 2))
            sub = {}
            check_dw(
                "dw", "x", dtype, lambda: rb.rowblock_bwd_cuda(stage, xs, weights, g,
                                                               weight_grads=True),
                lambda: stage.bwd(xs, weights, g, weight_grads=True), len(xs), sub,
            )
            shape_entry(report, f"rowblock_bwd_dw[{stage.name}]", f"{key}_{name}", dtype,
                        sub["dw"]["max_abs_err_x"], sub["dw"]["bound_ratio_x"], sub["dw"]["ms_x"],
                        sub["dw"]["plain_ms_x"])
        torch.cuda.empty_cache()


def check_attention_heads(A, gen, device, report):
    """The window-attention pair at the head widths of HEAD_SHAPES (8, 12,
    24, 64), windows of T = 65, both dtypes."""
    from metatrain_tpu_torch.ops.kernels import attention as ak

    for M, D, H, _ in HEAD_SHAPES:
        q, k, v, g, bias = attention_case(A, M + 1, D, gen, device)
        scale = 1.0 / math.sqrt(D // H)
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd, gd = (x.to(dtype) for x in (q, k, v, g))
            for name, k_fn, p_fn in (
                ("window_attention_fwd",
                 lambda: (ak.window_attention_fwd_cuda(qd, kd, vd, bias, H, scale),),
                 lambda: (ak.attention_math(qd, kd, vd, bias, H, scale),)),
                ("window_attention_bwd",
                 lambda: ak.window_attention_bwd_cuda(qd, kd, vd, bias, gd, H, scale),
                 lambda: ak.attention_bwd_math(qd, kd, vd, bias, gd, H, scale)),
            ):
                err, worst = compare(k_fn(), p_fn(), dtype)
                shape_entry(report, name, f"T{M + 1}_D{D}_H{H}", dtype, err, worst,
                            cuda_ms(k_fn, 3), cuda_ms(p_fn, 2))
        torch.cuda.empty_cache()


def gnn_case(A, M, D, H, F, N, L, gen, device, expanded=True):
    """Inputs of the GNN block: L layers' weights as :func:`layer_case` and,
    with the expansion, the node stream's (lecun-scaled matrices, small
    biases, norm scales near 1; without it the node width is D), node
    features, cotangents."""
    from metatrain_tpu_torch.ops.kernels.gnn_block import CenterWeights, flatten_gnn_weights

    def lecun(*shape):
        return (torch.randn(*shape, generator=gen) / math.sqrt(shape[0])).to(device)

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=gen)).to(device)

    edges, _, cf, _, g_edge, _ = layer_case(A, M, D, H, F, gen, device)
    lws = [layer_case(1, M, D, H, F, gen, device)[3] for _ in range(L)]
    cws = [CenterWeights(lecun(N, D), vec(D), lecun(D, N), vec(N), vec(N, 1.0), lecun(N, 4 * N),
                         vec(4 * N), lecun(2 * N, N), vec(N)) if expanded else None
           for _ in range(L)]
    node = torch.randn(A, N if expanded else D, generator=gen).to(device)
    g_node = torch.randn(*node.shape, generator=gen).to(device)
    return edges, node, cf, lws, cws, flatten_gnn_weights(lws, cws, expanded), g_edge, g_node


def check_gnn_block_variants(M, D, H, F, N, gen, device, A=256):
    """The block's general kernels (``sm90=False``) vs their plain versions
    in the configurations the default model does not run: without the node
    expansion (d_node == d_pet) over 3 layers (two edge-cotangent buffers)
    and with it over one layer; float32 and bfloat16, the bounds of
    :func:`compare` and :func:`compare_dw`. Returns the errors; raises past a
    bound."""
    from metatrain_tpu_torch.ops.kernels import gnn_block as gb

    scale = 1.0 / math.sqrt(D // H)
    report = {}
    for expanded, L in ((False, 3), (True, 1)):
        edges, node, cf, lws, cws, flat, g_edge, g_node = gnn_case(A, M, D, H, F, N, L, gen,
                                                                   device, expanded)
        for dtype in (torch.float32, torch.bfloat16):
            e, n, ge, gn = (x.to(dtype) for x in (edges, node, g_edge, g_node))
            fwd = compare(gb.gnn_block_fwd_cuda(e, n, cf, flat, H, scale, L, expanded, sm90=False),
                          gb.gnn_block_math(e, n, cf, lws, cws, H, scale, expanded), dtype)
            k = gb.gnn_block_bwd_cuda(e, n, cf, flat, ge, gn, H, scale, L, expanded, True,
                                      sm90=False)
            p = gb.gnn_block_bwd_math(e, n, cf, lws, cws, ge, gn, H, scale, expanded, True)
            torch.cuda.synchronize()
            bwd = compare(k[:3], p[:3], dtype)
            dw = compare_dw(k[3], p[3], dtype)
            key = f"{'expanded' if expanded else 'plain_node'}_L{L}_{dtype}".replace("torch.", "")
            report[key] = {"fwd": fwd, "bwd": bwd, "dw": dw}
    return report


def per_layer_layers(lws, cws, H, N, dtype, device):
    """The per-layer fused path of the same GNN layer: one
    ``FusedTransformerLayer`` (K1/K2 and the node stream in PyTorch ops) per
    attention layer, holding the block's weights. Its time is the block's
    yardstick ``per_layer_ms``."""
    from metatrain_tpu_torch.models.pet.modules import FusedTransformerLayer

    layers = []
    for lw, cw in zip(lws, cws):
        D, F = lw.w_qkv.shape[0], lw.w_ffn_out.shape[0]
        layer = FusedTransformerLayer(D, H, N, F, 1.0, dtype, plain=False).to(device)
        with torch.no_grad():
            for name, w in lw._asdict().items():
                getattr(layer, name).copy_(w)
            layer.center_contraction.weight.copy_(cw.w_contr.T)
            layer.center_contraction.bias.copy_(cw.b_contr)
            layer.center_expansion.weight.copy_(cw.w_exp.T)
            layer.center_expansion.bias.copy_(cw.b_exp)
            layer.norm_center_features.weight.copy_(cw.norm_c)
            layer.center_mlp.w_in.weight.copy_(cw.w_in_c.T)
            layer.center_mlp.w_in.bias.copy_(cw.b_in_c)
            layer.center_mlp.w_out.weight.copy_(cw.w_out_c.T)
            layer.center_mlp.w_out.bias.copy_(cw.b_out_c)
        layers.append(layer)
    return layers


def per_layer_fns(layers, edges, node, cf, g_edge, g_node):
    """(forward, backward, backward with weight gradients) callables of the
    per-layer path: the forward, with no weight requiring grad (as the served
    call runs it: the Hopper K1 in bf16); ``autograd.grad`` of its outputs
    to the inputs (2 x K2 and the node stream's backward); and to the inputs
    and the weights (2 x K2-dW), on a retained graph."""
    params = [p for layer in layers for p in layer.parameters()]

    def fwd():
        flags = [p.requires_grad for p in params]
        for p in params:
            p.requires_grad_(False)
        n, e = node, edges
        for layer in layers:
            n, e = layer(n, e, cf)
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)
        return e, n

    x = [t.detach().requires_grad_(True) for t in (edges, node)]

    def graph(weights):
        for p in params:
            p.requires_grad_(weights)
        n, e = x[1], x[0]
        for layer in layers:
            n, e = layer(n, e, cf)
        return e, n

    def bwd_fn(weights):
        outs = graph(weights)
        inputs = x + (params if weights else [])
        return lambda: torch.autograd.grad(outs, inputs, (g_edge, g_node), retain_graph=True)

    return fwd, bwd_fn(False), bwd_fn(True)


def gnn_bounds(A, M, D, H, F, N, n_weights, dtype, L):
    """(bytes, operations) of the block's forward, backward and
    weight-gradient backward and of the Hopper node-stream kernels
    (forward: the update and the next contraction; backward: the
    contraction's backward of the layer above and the update's, its forward
    recomputed; float32 also the backward's spill mode, whose operands and
    tile sums are outputs of its function), at A atoms: each input read
    once, each output written once. The dense products per attention layer
    as check_fused_layer counts them, the node stream's per atom
    (contraction, expansion, center MLP)."""
    s_ = torch.tensor([], dtype=dtype).element_size()
    dense = A * M * (8 * D * D + 6 * D * F)
    attention = 4 * A * H * M * M * (D // H)
    center = 2 * A * (2 * N * D + 6 * N * N)
    act = A * M * D * s_ + A * N * s_  # one (edges, node) pair
    update = N * D + D * N + 6 * N * N + 7 * N  # w_contr, w_exp, w_in_c, w_out_c, vectors
    node_bwd = (A * (s_ * N + s_ * D + 4 * N + s_ * D) + A * (s_ * D + 4 * N) + s_ * update,
                2 * A * (3 * N * D + 10 * N * N))
    spill = 4 * (A * 8 * N + -(-A // 64) * (D + 7 * N))  # hn, h, d_vg, d_n; the tiles' sums
    return {
        "gnn_block_fwd": (2 * act + A * M * 4 + n_weights * s_, L * (dense + attention + center)),
        "gnn_block_bwd": (4 * act + 2 * A * M * 4 + n_weights * s_,
                          L * (2 * dense + 3 * attention + 2 * center)),
        "gnn_block_bwd_dw": (4 * act + 2 * A * M * 4 + n_weights * (s_ + 4),
                             L * (3 * dense + 3 * attention + 3 * center)),
        "gnn_node_fwd": (s_ * (A * (2 * N + 2 * D) + update + D), 2 * A * (2 * N * D + 6 * N * N)),
        "gnn_node_bwd": node_bwd,
        "gnn_node_bwd_dw": (node_bwd[0] + spill, node_bwd[1]),
    }


def hopper_gnn_names(dtype):
    """The Hopper block's entries in ``dtype``: the bf16 call's forward and
    backward, or the float32 call's and step's with the weight-gradient
    backward; and the node-stream kernels' entries."""
    if dtype == torch.bfloat16:
        return (["gnn_block_fwd_sm90", "gnn_block_bwd_sm90"],
                ["gnn_node_fwd_sm90", "gnn_node_bwd_sm90"])
    return (["gnn_block_fwd_f32_sm90", "gnn_block_bwd_f32_sm90", "gnn_block_bwd_dw_f32_sm90"],
            ["gnn_node_fwd_f32_sm90", "gnn_node_bwd_f32_sm90", "gnn_node_bwd_dw_f32_sm90"])


def general_name(name):
    """The general kernel (or plain bound) a Hopper entry stands beside."""
    return name.replace("_f32_sm90", "").replace("_sm90", "")


def check_gnn_block(A, M, D, H, F, N, gen, device, report, L=2):
    """The GNN block vs its plain versions at the served shape: the general
    kernels (``sm90=False``) in float32 and bfloat16; the Hopper block in
    bfloat16 (``gnn_block_{fwd,bwd}_sm90``, the served bf16 path) and in
    float32 (``gnn_block_{fwd,bwd,bwd_dw}_f32_sm90``, the f32 call and the
    f32 step) and its node-stream kernels, with the per-layer path's time
    and the general kernel's beside the Hopper entries (float32 bounds at
    the 3xTF32 peak, the FFMA bound beside). The Hopper backward's recompute
    must give the forward's per-layer values bit for bit (float32: the
    weight-gradient backward's too, against the forward with weight
    gradients), and two launches of it the same bits."""
    from metatrain_tpu_torch.ops.kernels import gnn_block as gb

    edges, node, cf, lws, cws, flat, g_edge, g_node = gnn_case(A, M, D, H, F, N, L, gen, device)
    scale = 1.0 / math.sqrt(D // H)
    n_weights = sum(x.numel() for x in flat)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        bounds = gnn_bounds(A, M, D, H, F, N, n_weights, dtype, L)
        blocks, _ = hopper_gnn_names(dtype)
        for name in list(GNN_GENERAL) + blocks:
            entry = report.setdefault(name, {"library_ms": None})
            if name in GNN_GENERAL or dtype == torch.bfloat16:
                record_bound(entry, tag, *bounds[general_name(name)], dtype)
            else:
                k4_f32_bounds(entry, tag, bounds[general_name(name)])
        e, n, ge, gn = (x.to(dtype) for x in (edges, node, g_edge, g_node))
        plain_ws = (lws, cws)
        fwd = lambda: gb.gnn_block_math(e, n, cf, *plain_ws, H, scale, True)  # noqa: E731
        bwd = lambda: gb.gnn_block_bwd_math(e, n, cf, *plain_ws, ge, gn, H, scale, True)  # noqa: E731
        cases = [
            ("gnn_block_fwd",
             lambda: gb.gnn_block_fwd_cuda(e, n, cf, flat, H, scale, L, True, sm90=False), fwd),
            ("gnn_block_bwd",
             lambda: gb.gnn_block_bwd_cuda(e, n, cf, flat, ge, gn, H, scale, L, True, sm90=False),
             bwd),
            (blocks[0], lambda: gb.gnn_block_fwd_cuda(e, n, cf, flat, H, scale, L, True), fwd),
            (blocks[1], lambda: gb.gnn_block_bwd_cuda(e, n, cf, flat, ge, gn, H, scale, L, True),
             bwd),
        ]
        for name, k_fn, p_fn in cases:
            k_out, p_out = k_fn(), p_fn()
            torch.cuda.synchronize()
            err, worst = compare(k_out, p_out, dtype)
            del k_out, p_out
            torch.cuda.empty_cache()
            entry = report[name]
            entry[f"max_abs_err_{tag}"] = err
            entry[f"bound_ratio_{tag}"] = worst
            entry[f"ms_{tag}"] = cuda_ms(k_fn)
            entry[f"plain_ms_{tag}"] = cuda_ms(p_fn)
        plain_dw = lambda: (lambda o: (*o[:3], *o[3]))(  # noqa: E731
            gb.gnn_block_bwd_math(e, n, cf, *plain_ws, ge, gn, H, scale, True, True))
        for name, sm90 in (("gnn_block_bwd_dw", False),) + (
                ((blocks[2], True),) if dtype == torch.float32 else ()):
            check_dw(name, tag, dtype, lambda: (lambda o: (*o[:3], *o[3]))(
                gb.gnn_block_bwd_cuda(e, n, cf, flat, ge, gn, H, scale, L, True, True,
                                      sm90=sm90)), plain_dw, 3, report)
            torch.cuda.empty_cache()
        check_gnn_sm90_recompute(e, n, cf, flat, ge, gn, H, scale, L, report)
        check_gnn_node_kernels(A, D, N, cws, bounds, gen, device, report, dtype)
        layers = per_layer_layers(lws, cws, H, N, dtype, device)
        fns = per_layer_fns(layers, e, n, cf, ge, gn)
        for name, fn in zip(GNN_GENERAL, fns):
            with torch.no_grad() if name == "gnn_block_fwd" else torch.enable_grad():
                report[name][f"per_layer_ms_{tag}"] = cuda_ms(fn)
        for name in blocks:
            general = report[general_name(name)]
            report[name][f"per_layer_ms_{tag}"] = general[f"per_layer_ms_{tag}"]
            report[name][f"general_ms_{tag}"] = general[f"ms_{tag}"]
        del layers, fns
        torch.cuda.empty_cache()


def check_gnn_sm90_recompute(e, n, cf, flat, ge, gn, H, scale, L, report):
    """The Hopper backward's recomputed per-layer values (edges, node,
    center, cattn) equal the forward's bit for bit (one launch sequence;
    float32: also the weight-gradient backward's against the forward with
    weight gradients, the f32 step's energy and forces), and two backward
    launches give the same bits."""
    from metatrain_tpu_torch.ops.kernels import gnn_block as gb

    f32 = e.dtype == torch.float32
    blocks, _ = hopper_gnn_names(e.dtype)
    tag = "f32" if f32 else "bf16"
    runs = [(False, False)] + ([(True, True)] if f32 else [])
    for weight_grads, dw in runs:
        fwd_trace, bwd_trace = [], []
        gb.gnn_block_fwd_cuda(e, n, cf, flat, H, scale, L, True, weight_grads=weight_grads,
                              trace=fwd_trace)
        first = gb.gnn_block_bwd_cuda(e, n, cf, flat, ge, gn, H, scale, L, True, dw,
                                      trace=bwd_trace)
        again = gb.gnn_block_bwd_cuda(e, n, cf, flat, ge, gn, H, scale, L, True, dw)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for f, b in zip(fwd_trace, bwd_trace) for x, y in zip(f, b))
        if len(fwd_trace) != L or len(bwd_trace) != L or not same:
            fail(f"the Hopper block's recompute differs from its forward ({tag}, dW {dw})")
        flat_out = lambda o: list(o[:3]) + (list(o[3]) if dw else [])  # noqa: E731
        if not all(torch.equal(a, b) for a, b in zip(flat_out(first), flat_out(again))):
            fail(f"two launches of the Hopper block's backward differ ({tag}, dW {dw})")
        name = blocks[2] if dw else blocks[1]
        report[name]["recompute_equal_forward"] = True
        report[name][f"bitwise_repeat_{tag}"] = True
        del fwd_trace, bwd_trace, first, again
    torch.cuda.empty_cache()


def check_gnn_node_kernels(A, D, N, cws, bounds, gen, device, report, dtype=torch.bfloat16):
    """The Hopper node-stream kernels alone at the served shape, in the modes
    of a middle layer boundary (the update and the next contraction; the
    contraction's backward and the update's): kernel vs plain
    (``node_stream_{fwd,bwd}_math``) and times; the other modes (the first
    contraction, the last update, the last contraction's backward) held to
    the plain version too. float32 also the spill mode
    (``gnn_node_bwd_dw_f32_sm90``): its outputs equal the input-gradient
    mode's bit for bit, its operands and tile sums within the bounds of
    ``node_stream_bwd_dw_math``'s, and the layer's second pass
    (``gnn_node_dw_cuda``) against ``node_stream_dw_math`` at the
    weight-gradient bound, bitwise on a repeat, timed (``product_ms``)."""
    from metatrain_tpu_torch.ops.kernels import _lib
    from metatrain_tpu_torch.ops.kernels import gnn_block as gb

    bf, f32 = torch.bfloat16, dtype == torch.float32
    tag = "f32" if f32 else "bf16"
    node = torch.randn(A, N, generator=gen).to(device, dtype)
    cattn = torch.randn(A, D, generator=gen).to(device, dtype)
    dn = torch.randn(A, N, generator=gen).to(device)
    d_center = torch.randn(A, D, generator=gen).to(device, dtype)
    cw, cn = cws[0], cws[1]
    nw, nn_ = gb.node_sm90_weights(cw, dtype), gb.node_sm90_weights(cn, dtype)
    fwd = lambda: gb.gnn_node_fwd_cuda(node, cattn, nw, nn_)  # noqa: E731
    bwd = lambda: gb.gnn_node_bwd_cuda(node, cattn, dn, d_center, nn_, nw)  # noqa: E731
    cases = {
        "fwd": [(fwd, lambda: gb.node_stream_fwd_math(node, cattn, cw, cn)),
                (lambda: gb.gnn_node_fwd_cuda(node, None, None, nn_)[1:],
                 lambda: gb.node_stream_fwd_math(node, None, None, cn)[1:]),
                (lambda: gb.gnn_node_fwd_cuda(node, cattn, nw, None)[:1],
                 lambda: gb.node_stream_fwd_math(node, cattn, cw, None)[:1])],
        "bwd": [(bwd, lambda: gb.node_stream_bwd_math(node, cattn, dn, d_center, cn, cw)),
                (lambda: gb.gnn_node_bwd_cuda(node, cattn, dn.to(dtype), None, None, nw),
                 lambda: gb.node_stream_bwd_math(node, cattn, dn.to(dtype), None, None, cw)),
                (lambda: (gb.gnn_node_bwd_cuda(None, None, dn, d_center, nw, None),),
                 lambda: (gb.node_stream_bwd_math(None, None, dn, d_center, cw, None),))],
    }
    _, names = hopper_gnn_names(dtype)
    for (kind, runs), name in zip(cases.items(), names):
        entry = report.setdefault(name, {"library_ms": None})
        if f32:
            k4_f32_bounds(entry, tag, bounds[general_name(name)])
        else:
            record_bound(entry, tag, *bounds[general_name(name)], bf)
        errs, worst = [], 0.0
        for k_fn, p_fn in runs:
            k_out, p_out = k_fn(), p_fn()
            torch.cuda.synchronize()
            err, ratio = compare(k_out, p_out, dtype)
            errs.append(err)
            worst = max(worst, ratio)
        entry[f"max_abs_err_{tag}"] = errs[0]
        entry[f"other_modes_max_abs_err_{tag}"] = errs[1:]
        entry[f"bound_ratio_{tag}"] = worst
        k_fn, p_fn = runs[0]
        entry[f"ms_{tag}"] = cuda_ms(k_fn)
        entry[f"plain_ms_{tag}"] = cuda_ms(p_fn)
    if f32:
        entry = report.setdefault(names[2], {"library_ms": None})
        k4_f32_bounds(entry, tag, bounds["gnn_node_bwd_dw"])
        tiles = -(-A // 64)
        above = gb.NodeSpill(*(None,) * 5, torch.zeros(tiles, D + 7 * N, device=device))
        spill = lambda: gb.gnn_node_bwd_dw_cuda(node, cattn, dn, d_center, nn_, nw, above)  # noqa: E731
        plain = lambda: gb.node_stream_bwd_dw_math(node, cattn, dn, d_center, cn, cw)  # noqa: E731
        (k_out, ops), (p_out, p_ops) = spill(), plain()
        # the layer's own b_contr sums: the contraction's backward below it
        d_center_0 = torch.randn(A, D, generator=gen).to(device)
        gb.gnn_node_bwd_dw_cuda(None, None, dn, d_center_0, nw, None, ops)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(k_out, bwd())):
            fail("the f32 node backward's spill mode changed its outputs")
        ratio = compare(k_out, p_out, dtype)[1]
        fields = ("hn", "h", "d_vg", "d_n", "d_nmid")
        err, r_ops = compare([getattr(ops, f) for f in fields], [getattr(p_ops, f) for f in fields],
                             dtype)
        sums = [above.vec[:, :D].sum(0), ops.vec[:, :D].sum(0)]
        r_sums = compare_dw(sums, [d_center.sum(0), d_center_0.sum(0)], dtype)[1]
        product = lambda: gb.gnn_node_dw_cuda(node, cattn, d_center_0, ops)  # noqa: E731
        p_dw = lambda: gb.node_stream_dw_math(node, cattn, d_center_0, p_ops,  # noqa: E731
                                              _lib.sm_count(device))
        k_dw, again = product(), product()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(k_dw, again)):
            fail("two launches of the f32 node products differ")
        err_dw, r_dw = compare_dw(k_dw, p_dw(), dtype)
        entry.update({f"max_abs_err_{tag}": max(err, err_dw),
                      f"bound_ratio_{tag}": max(ratio, r_ops, r_sums, r_dw),
                      f"dw_max_abs_err_{tag}": err_dw, f"outputs_equal_bwd_{tag}": True,
                      f"bitwise_repeat_{tag}": True, f"ms_{tag}": cuda_ms(spill),
                      f"plain_ms_{tag}": cuda_ms(plain), f"product_ms_{tag}": cuda_ms(product),
                      f"product_plain_ms_{tag}": cuda_ms(p_dw)})
        del ops, p_ops, k_dw, again
    torch.cuda.empty_cache()


def check_gnn_sm90_shapes(D, H, F, gen, device, report, A=1024):
    """The Hopper block vs its plain versions at M = 64, 48, 16 and 1 or 3
    layers, with and without the node expansion (d_node 256; and d_node 128
    at M = 64, 2 layers), bf16 (forward, backward: relative RMS <= 2e-2 per
    output) and float32 (forward, backward, weight-gradient backward: the
    float32 bounds), A atoms, times under the Hopper entries' ``shapes``.
    Each run must launch the Hopper layer kernels and, with the expansion,
    the node kernels (float32 weight gradients: K2-dW, the spill mode and
    its products), and never the general block."""
    from metatrain_tpu_torch.ops.kernels import _lib
    from metatrain_tpu_torch.ops.kernels import gnn_block as gb

    configs = [(M, L, expanded, 256) for M in (64, 48, 16) for L in (1, 3)
               for expanded in (True, False)] + [(64, 2, True, 128)]
    for M, L, expanded, N in configs:
        edges, node, cf, lws, cws, flat, g_edge, g_node = gnn_case(A, M, D, H, F, N, L, gen, device,
                                                                   expanded)
        scale = 1.0 / math.sqrt(D // H)
        key = f"M{M}_L{L}_{f'N{N}' if expanded else 'plain_node'}_A{A}"
        for dtype in (torch.bfloat16, torch.float32):
            f32 = dtype == torch.float32
            e, n, ge, gn = (x.to(dtype) for x in (edges, node, g_edge, g_node))
            blocks, _ = hopper_gnn_names(dtype)
            k1, node_fwd = (K1_F32, "gnn_node_fwd_f32_sm90") if f32 else (
                "fused_layer_fwd_sm90", "gnn_node_fwd_sm90")
            k2 = "fused_layer_bwd_f32_sm90" if f32 else "fused_layer_bwd_sm90"
            node_bwd = "gnn_node_bwd_f32_sm90" if f32 else "gnn_node_bwd_sm90"
            runs = [
                (blocks[0], lambda: gb.gnn_block_fwd_cuda(e, n, cf, flat, H, scale, L, expanded),
                 lambda: gb.gnn_block_math(e, n, cf, lws, cws, H, scale, expanded),
                 {k1}, {node_fwd}),
                (blocks[1],
                 lambda: gb.gnn_block_bwd_cuda(e, n, cf, flat, ge, gn, H, scale, L, expanded),
                 lambda: gb.gnn_block_bwd_math(e, n, cf, lws, cws, ge, gn, H, scale, expanded),
                 {k1, k2}, {node_fwd, node_bwd}),
            ]
            if f32:
                runs.append((
                    blocks[2],
                    lambda: (lambda o: (*o[:3], *o[3]))(gb.gnn_block_bwd_cuda(
                        e, n, cf, flat, ge, gn, H, scale, L, expanded, True)),
                    lambda: (lambda o: (*o[:3], *o[3]))(gb.gnn_block_bwd_math(
                        e, n, cf, lws, cws, ge, gn, H, scale, expanded, True)),
                    {k1, *K2DW_F32}, {node_fwd, "gnn_node_bwd_dw_f32_sm90", "gnn_node_dw_product"}))
            for name, k_fn, p_fn, layer_kernels, node_kernels in runs:
                _lib.LAUNCHES.clear()
                k_out = k_fn()
                torch.cuda.synchronize()
                launched = dict(_lib.LAUNCHES)
                want = layer_kernels | (node_kernels if expanded else set())
                if set(launched) != want:
                    fail(f"{name} at {key} launched {launched}, expected {sorted(want)}")
                p_out = p_fn()
                if name.startswith("gnn_block_bwd_dw"):
                    err, worst = compare(k_out[:3], p_out[:3], dtype)
                    err_w, worst_w = compare_dw(k_out[3:], p_out[3:], dtype)
                    err, worst = max(err, err_w), max(worst, worst_w)
                else:
                    err, worst = compare(k_out, p_out, dtype)
                del k_out, p_out
                shape_entry(report, name, key, dtype, err, worst, cuda_ms(k_fn, 3),
                            cuda_ms(p_fn, 2))
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


def rowblock_sizes(stage, xs, weights, g):
    """(bytes, operations) of K3 (and the Hopper K3, the Hopper float32 K3), K4 (and the Hopper K4,
    the Hopper float32 K4) and K4-dW at these inputs. K3 reads every input
    and writes the output, and runs the stage's two products. K4 reads the
    inputs it differentiates (compress: the parts; combination: edges and
    reversed, not the messages), g and the weights but b1, writes one
    cotangent per input it reads, and runs three products (pre, g w1^T,
    d_pre w0^T); the head recomputes both layers (b1 read, four products).
    K4-dW moves K4's bytes and writes the float weight gradients, and runs
    K4's products and the two X^T dY (X^T d_pre, h^T g); the head's six
    (its two layers recomputed, two input-side and two X^T dY)."""
    from metatrain_tpu_torch.ops.kernels import rowblock as rb

    (_, _), (w0, _, w1, b1) = rb._split_weights(stage, weights)
    rows_, d_part = xs[0].shape
    s_ = xs[0].element_size()
    w_in, w_hid = w0.shape
    w_out = w1.shape[1]
    flops = 2 * rows_ * (w_in * w_hid + w_hid * w_out)
    n_w = sum(x.numel() for x in weights)
    io_in = len(xs) * rows_ * d_part * s_
    io_g = rows_ * w_out * s_
    n_grads = rb._n_input_grads(stage, len(xs))
    io_d = n_grads * rows_ * d_part * s_
    head = stage.code == rb.HEAD_CODE
    k4 = (2 * io_d + io_g + (n_w - (0 if head else b1.numel())) * s_,
          2 * flops if head else 2 * rows_ * (w_in * w_hid + w_out * w_hid + w_hid * w_in))
    k4dw = ((io_in + io_g + io_d + n_w * (s_ + 4), 3 * flops) if head else
            (2 * io_d + io_g + n_w * (s_ + 4),
             2 * rows_ * (3 * w_in * w_hid + 2 * w_hid * w_out)))
    return {f"rowblock_fwd[{stage.name}]": (io_in + io_g + n_w * s_, flops),
            f"rowblock_fwd_sm90[{stage.name}]": (io_in + io_g + n_w * s_, flops),
            f"rowblock_fwd_f32_sm90[{stage.name}]": (io_in + io_g + n_w * s_, flops),
            f"rowblock_bwd[{stage.name}]": k4,
            f"rowblock_bwd_sm90[{stage.name}]": k4,
            f"rowblock_bwd_f32_sm90[{stage.name}]": k4,
            f"rowblock_bwd_dw[{stage.name}]": k4dw,
            f"rowblock_bwd_dw_f32_sm90[{stage.name}]": k4dw}


def check_rowblock_sm90(kind, stage, xs, weights, g, k_out, p_out, size):
    """The Hopper K3's (``kind`` "fwd") or K4's ("bwd") checks at one shape
    (bf16): relative RMS <= 2e-2 of the plain version for every output, the
    outputs bitwise equal across two launches, the general body
    (``sm90=False``) against the same plain version; its time, the general
    body's, the bound of ``size`` (bytes, operations) and, reported and not
    gated, whether its outputs equal the general body's bit for bit. For
    the head's backward also the shared front: the Hopper K4 head's
    recompute of the forward must equal the Hopper K3 head's output bit
    for bit, and its d_x this launch's."""
    from metatrain_tpu_torch.ops.kernels import rowblock as rb

    def run(**kw):
        if kind == "fwd":
            return (rb.rowblock_fwd_cuda(stage, xs, weights, **kw),)
        return rb.rowblock_bwd_cuda(stage, xs, weights, g, **kw)

    title = "the Hopper K3" if kind == "fwd" else "the Hopper K4"
    again = run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k_out, again)):
        fail(f"{title} ({stage.name}) gave different outputs in two launches")
    err, worst = compare(k_out, p_out, torch.bfloat16)
    g_out = run(sm90=False)
    _, g_worst = compare(g_out, p_out, torch.bfloat16)
    bound = {}
    record_bound(bound, "x", *size, torch.bfloat16)
    front = {}
    if kind == "bwd" and stage.code == rb.HEAD_CODE:
        d_x, recomputed = rb.k4_sm90_head_front(stage, xs, weights, g)
        served = rb.rowblock_fwd_cuda(stage, xs, weights)
        torch.cuda.synchronize()
        if not (torch.equal(recomputed, served) and torch.equal(d_x, k_out[0])):
            fail("the Hopper K4 head's recomputed forward differs from the Hopper K3 head's "
                 f"output at {xs[0].shape[0]} rows")
        front["front_equal_k3"] = True
    return {**front, "max_abs_err": err, "bound_ratio": worst, "bitwise_repeat": True,
            "equal_general": all(torch.equal(a, b) for a, b in zip(k_out, g_out)),
            "ms": cuda_ms(run), "general_ms": cuda_ms(lambda: run(sm90=False)),
            "general_bound_ratio": g_worst,
            "bound_ms": bound["bound_ms_x"], "bound_by": bound["bound_by_x"]}


def check_rowblock(rows, D, gen, device, report):
    """K3, K4 and K4-dW vs their plain versions at ``rows``, both dtypes; in
    bf16 the compress and combination of K3 and K4 are the Hopper K3 and
    K4, entries of their own (``rowblock_fwd_sm90[<stage>]``,
    ``rowblock_bwd_sm90[<stage>]``, the 2-part compress under their
    ``shapes``), while ``rowblock_fwd[<stage>]`` and
    ``rowblock_bwd[<stage>]`` keep the general bodies (``sm90=False``)."""
    from metatrain_tpu_torch.ops.kernels import _lib
    from metatrain_tpu_torch.ops.kernels import rowblock as rb

    for stage, inputs, weights in stage_cases(rows, D, gen, device):
        for dtype in (torch.float32, torch.bfloat16):
            xs = tuple(t.to(dtype) for t in inputs)
            g = torch.randn(rows, weights[-1].shape[0], generator=gen).to(device, dtype)
            tag = "f32" if dtype == torch.float32 else "bf16"
            k4_name = f"rowblock_bwd_sm90[{stage.name}]"
            k3_name = f"rowblock_fwd_sm90[{stage.name}]"
            before = _lib.LAUNCHES[k4_name], _lib.LAUNCHES[k3_name]
            bwd_k = rb.rowblock_bwd_cuda(stage, xs, weights, g)
            fwd_k = rb.rowblock_fwd_cuda(stage, xs, weights)
            torch.cuda.synchronize()
            k4_sm90 = _lib.LAUNCHES[k4_name] > before[0]
            k3_sm90 = _lib.LAUNCHES[k3_name] > before[1]
            (_, _), (w0, _, w1, _) = rb._split_weights(stage, weights)
            widths = (D, w0.shape[0], w0.shape[1], w1.shape[1])
            if k4_sm90 != _lib.k4_sm90_takes(dtype, stage.code, *widths):
                fail(f"K4 {stage.name} {dtype}: the Hopper kernel ran: {k4_sm90}, "
                     "the rule says otherwise")
            if k3_sm90 != _lib.k3_sm90_takes(dtype, stage.code, *widths):
                fail(f"K3 {stage.name} {dtype}: the Hopper kernel ran: {k3_sm90}, "
                     "the rule says otherwise")
            sizes = rowblock_sizes(stage, xs, weights, g)
            cases = (
                (f"rowblock_fwd[{stage.name}]",
                 lambda: (rb.rowblock_fwd_cuda(stage, xs, weights, sm90=False),),
                 lambda: (stage.math(xs, weights),)),
                (f"rowblock_bwd[{stage.name}]",
                 lambda: rb.rowblock_bwd_cuda(stage, xs, weights, g, sm90=False),
                 lambda: stage.bwd(xs, weights, g)),
            )
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
            for kind, ran, name, k_out, p_fn in (
                    ("bwd", k4_sm90, k4_name, bwd_k, lambda: stage.bwd(xs, weights, g)),
                    ("fwd", k3_sm90, k3_name, (fwd_k,), lambda: (stage.math(xs, weights),))):
                if not ran:
                    continue
                sub = check_rowblock_sm90(kind, stage, xs, weights, g, k_out, p_fn(), sizes[name])
                entry = report.setdefault(name, {"library_ms": None})
                if len(xs) < 3 and stage.name == "compress":
                    entry.setdefault("shapes", {})[f"rows{rows}_compress2"] = sub
                else:
                    entry.update({f"{k}_{tag}": v for k, v in sub.items()})
                    entry[f"plain_ms_{tag}"] = cuda_ms(p_fn)
            del bwd_k, fwd_k
            # the 2-part compress is checked too; the 3-part one's numbers stay
            dw_report = {} if len(xs) < 3 and stage.name == "compress" else report
            dw_name = f"rowblock_bwd_dw[{stage.name}]"
            record_bound(dw_report.setdefault(dw_name, {"library_ms": None}), tag,
                         *sizes[dw_name], dtype)
            check_dw(
                f"rowblock_bwd_dw[{stage.name}]", tag, dtype,
                lambda: rb.rowblock_bwd_cuda(stage, xs, weights, g, weight_grads=True, sm90=False),
                lambda: stage.bwd(xs, weights, g, weight_grads=True),
                len(xs), dw_report,
            )
            if dtype == torch.float32:
                check_k4_f32(stage, xs, weights, g, sizes, report)
                check_k3_f32(stage, xs, weights, sizes, report)
        torch.cuda.empty_cache()


def k4_f32_bounds(entry, tag, size):
    """The bound of ``size`` (bytes, operations) as 3xTF32 products
    (``bound_ms``) and on the FFMA pipes (``bound_ms_ffma``)."""
    record_bound(entry, tag, *size, torch.float32, peak=PEAK_3XTF32_OPS_PER_S)
    ffma = {}
    record_bound(ffma, "x", *size, torch.float32)
    entry[f"bound_ms_ffma_{tag}"] = ffma["bound_ms_x"]


def check_k4_f32(stage, xs, weights, g, sizes, report, key=None):
    """The Hopper float32 K4 and the two-pass K4-dW at one shape (float32):
    the rule's kernels ran; the input cotangents within 1e-4 of max |plain|,
    the weight gradients within ``compare_dw``'s bounds, every output
    bitwise equal over two launches, and K4-dW's input cotangents equal to
    K4's bit for bit (one body, two modes); the general body's time beside
    (``sm90=False``). With ``key`` the numbers go under the entries'
    ``shapes``; at the served rows (no ``key``) also the bounds, the
    spill's bytes, and the second pass alone on one chunk of the plan
    against ``rowblock_dw_from_operands`` (``product_ms``)."""
    from metatrain_tpu_torch.ops.kernels import _lib
    from metatrain_tpu_torch.ops.kernels import rowblock as rb

    (_, _), (w0, _, _, _) = rb._split_weights(stage, weights)
    w_in, w_hid = w0.shape
    rows = xs[0].shape[0]
    n = rb._n_input_grads(stage, len(xs))
    k4_name, dw_name = f"rowblock_bwd_f32_sm90[{stage.name}]", f"rowblock_bwd_dw_f32_sm90[{stage.name}]"
    before = _lib.LAUNCHES[k4_name], _lib.LAUNCHES[dw_name]
    k_out = rb.rowblock_bwd_cuda(stage, xs, weights, g)
    dw_out = rb.rowblock_bwd_cuda(stage, xs, weights, g, weight_grads=True)
    torch.cuda.synchronize()
    ran = (_lib.LAUNCHES[k4_name] - before[0], _lib.LAUNCHES[dw_name] - before[1])
    takes = _lib.k4_f32_sm90_takes(torch.float32, stage.code, xs[0].shape[1], w_in, w_hid,
                                   g.shape[1])
    if ran != ((1, 1) if takes else (0, 0)):
        fail(f"the Hopper float32 K4 ({stage.name}, {rows} rows) launched {ran}, the rule says "
             f"{takes}")
    if not all(torch.equal(a, b) for a, b in zip(k_out[:n], dw_out[:n])):
        fail(f"the two-pass K4-dW's input cotangents differ from the Hopper float32 K4's "
             f"({stage.name}, {rows} rows)")
    again = rb.rowblock_bwd_cuda(stage, xs, weights, g)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k_out, again)):
        fail(f"the Hopper float32 K4 ({stage.name}) gave different outputs in two launches")
    del again, dw_out
    err, worst = compare(k_out[:n], stage.bwd(xs, weights, g)[:n], torch.float32)
    del k_out
    general = lambda: rb.rowblock_bwd_cuda(stage, xs, weights, g, sm90=False)  # noqa: E731
    k4 = {"max_abs_err": err, "bound_ratio": worst, "bitwise_repeat": True,
          "ms": cuda_ms(lambda: rb.rowblock_bwd_cuda(stage, xs, weights, g)),
          "general_ms": cuda_ms(general)}
    dw = {}
    check_dw(dw_name, "x", torch.float32,
             lambda: rb.rowblock_bwd_cuda(stage, xs, weights, g, weight_grads=True),
             lambda: stage.bwd(xs, weights, g, weight_grads=True), n, {dw_name: dw})
    dw = {k[:-2]: v for k, v in dw.items()} | {"inputs_equal_k4": True, "general_ms": cuda_ms(
        lambda: rb.rowblock_bwd_cuda(stage, xs, weights, g, weight_grads=True, sm90=False), 3)}
    if key is not None:
        for name, sub in ((k4_name, k4), (dw_name, dw)):
            report.setdefault(name, {"library_ms": None}).setdefault("shapes", {})[key] = sub
        return
    sms = _lib.sm_count(g.device)
    plan = _lib.k4dw_plan(stage.code, rows, w_in, w_hid, sms)
    dw["workspace_bytes"] = plan.spill_bytes + 4 * max(plan.max_slices, 1) * sum(
        x.numel() for x in weights)
    dw["chunks"], dw["chunk_rows"] = plan.chunks, plan.chunk_tiles * _lib.ROW_TILE
    r1 = min(rows, dw["chunk_rows"])
    sub = [x[:r1] for x in xs]
    ops = rb.rowblock_dw_operands(stage, sub, weights, g[:r1])
    one = _lib.k4dw_plan(stage.code, r1, w_in, w_hid, sms, cap=1 << 62)
    k_dw = rb.rowblock_dw_product_cuda(stage, sub, g[:r1], ops, sms)
    p_dw = rb.rowblock_dw_from_operands(stage, sub, g[:r1], ops, one)
    torch.cuda.synchronize()
    dw["product_max_abs_err"], dw["product_bound_ratio"] = compare_dw(k_dw, p_dw, torch.float32)
    dw["product_ms"] = cuda_ms(lambda: rb.rowblock_dw_product_cuda(stage, sub, g[:r1], ops, sms))
    dw["product_plain_ms"] = cuda_ms(lambda: rb.rowblock_dw_from_operands(stage, sub, g[:r1], ops,
                                                                          one), 2)
    del ops, k_dw, p_dw
    for name, sub_entry in ((k4_name, k4), (dw_name, dw)):
        entry = report.setdefault(name, {"library_ms": None})
        if len(xs) < 3 and stage.name == "compress":
            entry.setdefault("shapes", {})[f"rows{rows}_compress2"] = sub_entry
            continue
        entry.update({f"{k}_f32": v for k, v in sub_entry.items()})
        entry["plain_ms_f32"] = cuda_ms(lambda: stage.bwd(xs, weights, g, weight_grads="_dw" in name))
        k4_f32_bounds(entry, "f32", sizes[name])
    torch.cuda.empty_cache()


def check_k3_f32(stage, xs, weights, sizes, report, key=None):
    """The Hopper float32 K3 at one shape (float32): the rule's kernel ran,
    with and without ``weight_grads``, to the same bits; the checks of
    ``check_f32_sm90_shape`` (within 1e-4 of max |plain|, bitwise repeat,
    the general body's time beside). With ``key`` the numbers go under the
    entry's ``shapes``; at the served rows (no ``key``) also the plain
    version's time and the bounds (the 2-part compress under ``shapes``)."""
    from metatrain_tpu_torch.ops.kernels import _lib
    from metatrain_tpu_torch.ops.kernels import rowblock as rb

    (_, _), (w0, _, w1, _) = rb._split_weights(stage, weights)
    rows = xs[0].shape[0]
    name = f"rowblock_fwd_f32_sm90[{stage.name}]"
    launch = lambda **kw: (rb.rowblock_fwd_cuda(stage, xs, weights, **kw),)  # noqa: E731
    before = _lib.LAUNCHES[name]
    k_out = launch()
    k_dw = launch(weight_grads=True)
    torch.cuda.synchronize()
    ran = _lib.LAUNCHES[name] - before
    takes = _lib.k3_f32_sm90_takes(torch.float32, stage.code, xs[0].shape[1], *w0.shape, w1.shape[1])
    if ran != (2 if takes else 0):
        fail(f"the Hopper float32 K3 ({stage.name}, {rows} rows) launched {ran} times in two "
             f"calls, the rule says {takes}")
    if not torch.equal(k_out[0], k_dw[0]):
        fail(f"the Hopper float32 K3 ({stage.name}, {rows} rows) gave other bits with weight_grads")
    del k_dw
    sub = check_f32_sm90_shape(name, launch, k_out, (stage.math(xs, weights),))
    entry = report.setdefault(name, {"library_ms": None})
    if key is not None or (len(xs) < 3 and stage.name == "compress"):
        entry.setdefault("shapes", {})[key or f"rows{rows}_compress2"] = sub
        return
    entry.update({f"{k}_f32": v for k, v in sub.items()})
    entry["plain_ms_f32"] = cuda_ms(lambda: stage.math(xs, weights))
    k4_f32_bounds(entry, "f32", sizes[name])


def check_rowblock_sm90_shapes(gen, device, report, D=128):
    """The Hopper K3 and K4 against the plain versions beyond the served
    rows: A x M rows at M = 64 (K3 only), 48 and 16 (A = 11,000) and a row
    count that is not a multiple of 64 (its last tile partial), every
    stage they take (bf16); the checks of ``check_rowblock_sm90`` and the
    bound, under each entry's ``shapes``."""
    from metatrain_tpu_torch.ops.kernels import _lib
    from metatrain_tpu_torch.ops.kernels import rowblock as rb

    for rows in (11000 * 64, 11000 * 48, 11000 * 16, 100003):
        for stage, inputs, weights in stage_cases(rows, D, gen, device):
            xs = tuple(t.to(torch.bfloat16) for t in inputs)
            g = torch.randn(rows, weights[-1].shape[0], generator=gen).to(device, torch.bfloat16)
            key = f"rows{rows}_{stage.name}{len(xs) if stage.name == 'compress' else ''}"
            sizes = rowblock_sizes(stage, xs, weights, g)
            kinds = [("fwd", lambda: (rb.rowblock_fwd_cuda(stage, xs, weights),),
                      lambda: (stage.math(xs, weights),))]
            if rows != 11000 * 64:
                kinds.append(("bwd", lambda: rb.rowblock_bwd_cuda(stage, xs, weights, g),
                              lambda: stage.bwd(xs, weights, g)))
            for kind, k_fn, p_fn in kinds:
                name = f"rowblock_{kind}_sm90[{stage.name}]"
                before = _lib.LAUNCHES[name]
                k_out = k_fn()
                torch.cuda.synchronize()
                if _lib.LAUNCHES[name] != before + 1:
                    fail(f"the Hopper K{3 if kind == 'fwd' else 4} did not take {stage.name} "
                         f"at {rows} rows")
                sub = check_rowblock_sm90(kind, stage, xs, weights, g, k_out, p_fn(), sizes[name])
                report.setdefault(name, {}).setdefault("shapes", {})[key] = sub
                del k_out
        torch.cuda.empty_cache()
    # the Hopper float32 K4 and the two-pass K4-dW: the 3-part compress and
    # the combination at A = 11,000 x M = 48 and at a partial last tile; the
    # Hopper float32 K3 also at M = 64 and 16; the head (K3, K4, K4-dW) at
    # all four
    for rows in (11000 * 64, 11000 * 48, 11000 * 16, 100003):
        cases = stage_cases(rows, D, gen, device)
        for stage, inputs, weights in (cases[0], cases[2], cases[3]):
            key = f"rows{rows}_{stage.name}{len(inputs) if stage.name == 'compress' else ''}"
            check_k3_f32(stage, inputs, weights, None, report, key=key)
            if rows in (11000 * 48, 100003) or stage.name == "head":
                g = torch.randn(rows, D, generator=gen).to(device)
                check_k4_f32(stage, inputs, weights, g, None, report, key=key)
        del cases
        torch.cuda.empty_cache()


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
M96 = {"cutoff": 5.5}  # the crystal's windows above 64 slots
D256 = {"d_pet": 256, "d_feedforward": 512, "num_heads": 8}
# LayerNorm / SiLU / PostLN layers and the residual featurizer; two GNN
# layers of one attention layer each, so the residual message mix (and the
# accumulate permute of its backward) is on the path
UNFUSED_ALT = {"fused_layers": False, "normalization": "LayerNorm", "activation": "SiLU",
               "transformer_type": "PostLN", "featurizer_type": "residual",
               "num_gnn_layers": 2, "num_attention_layers": 1}
ROWBLOCK_KERNELS = [f"rowblock_{d}[{s}]" for d in ("fwd", "bwd") for s in STAGE_NAMES]
# bf16 at d_pet 128: every stage runs the Hopper K3 and K4
ROWBLOCK_SM90_KERNELS = [f"rowblock_{d}_sm90[{s}]" for d in ("fwd", "bwd") for s in STAGE_NAMES]
FUSED_KERNELS = ["fused_layer_fwd", "fused_layer_bwd", "permute", "permute_acc"]
# the served shape (M = 64, D = 128) in bf16 takes the Hopper K1 and K2
FUSED_SM90_KERNELS = ["fused_layer_fwd_sm90", "fused_layer_bwd_sm90", "permute",
                      "permute_acc"] + ROWBLOCK_SM90_KERNELS
# the served bf16 call takes the Hopper block: each attention layer on the
# Hopper K1 and K2, the node stream on the node-stream kernels
GNN_KERNELS = (["gnn_node_fwd_sm90", "gnn_node_bwd_sm90", "fused_layer_fwd_sm90",
                "fused_layer_bwd_sm90", "permute", "permute_acc"] + ROWBLOCK_SM90_KERNELS)
# its launches per call (two blocks of two layers, d_node 256): the forward
# K1 2 and node 3 a block; the backward recomputes with the forward's
# sequence (K1 2, node 2: no last update), then K2 2 and node backward 3
GNN_SM90_PER_CALL = {"fused_layer_fwd_sm90": 8, "fused_layer_bwd_sm90": 4,
                     "gnn_node_fwd_sm90": 10, "gnn_node_bwd_sm90": 6}
GNN_GENERAL = ("gnn_block_fwd", "gnn_block_bwd", "gnn_block_bwd_dw")
GNN_M96_KERNELS = ["gnn_block_fwd", "gnn_block_bwd", "permute", "permute_acc"]
# the f32 call takes the Hopper float32 block: the Hopper float32 K1 and K2
# and the float32 node-stream kernels, the bf16 call's counts
GNN_F32_PER_CALL = {K1_F32: 8, "fused_layer_bwd_f32_sm90": 4, "gnn_node_fwd_f32_sm90": 10,
                    "gnn_node_bwd_f32_sm90": 6}
# the f32 G step: per block the forward (K1 2, node 3) and two
# weight-gradient backwards (the forces' and the loss's), each recomputing
# (K1 2, node 2) and then K2-dW 2, the node spill mode 3, its products 2
GNN_F32_PER_STEP = {K1_F32: 12, K2DW_F32[0]: 8, K2DW_F32[1]: 8, "gnn_node_fwd_f32_sm90": 14,
                    "gnn_node_bwd_dw_f32_sm90": 12, "gnn_node_dw_product": 8}
UNFUSED_KERNELS = ["window_attention_fwd", "window_attention_bwd", "permute", "permute_acc",
                   "rowblock_fwd_sm90[compress]", "rowblock_bwd_sm90[compress]",
                   "rowblock_fwd_sm90[head]", "rowblock_bwd_sm90[head]"]
# the row-block kernels' launches per bf16 force call (two GNN layers: the
# 2- and the 3-part compress, one combination each, one head; the residual
# featurizer no combination and a head per GNN layer), K3's and K4's alike:
# at d_pet 128 the Hopper kernels for every stage and never the general
# body, at d_pet 256 the general body
STAGES_PER_CALL = {"compress": 2, "combination": 2, "head": 1}
RESIDUAL_PER_CALL = {"compress": 2, "combination": 0, "head": 2}


def rowblock_per_call(per_stage, sm90=True):
    """Launches per call of the K3 and K4 kernels: ``per_stage`` on the
    Hopper kernels (``sm90``) or on the general bodies, none on the
    other."""
    return {f"rowblock_{d}{v}[{s}]": n if (v == "_sm90") == sm90 else 0
            for d in ("fwd", "bwd") for v in ("_sm90", "") for s, n in per_stage.items()}


ROWBLOCK_SM90_PER_CALL = rowblock_per_call(STAGES_PER_CALL)
ROWBLOCK_RESIDUAL_PER_CALL = rowblock_per_call(RESIDUAL_PER_CALL)
ROWBLOCK_D256_PER_CALL = rowblock_per_call(STAGES_PER_CALL, sm90=False)


def check_rowblock_launches(key, report, expected):
    """The row-block kernels' launches per force call of a served path
    (``report``'s ``launches_per_call``) equal ``expected``."""
    got = {k: report["launches_per_call"].get(k, 0) for k in expected}
    if got != expected:
        fail(f"{key}: the row-block kernels launched {got} per force call, expected {expected}")


def energy_info():
    from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info

    return DatasetInfo("angstrom", [29], {"energy": get_energy_target_info("eV")})


def random_state(hypers):
    """PET weights for ``hypers`` from a seeded generator."""
    from metatrain_tpu_torch.models.pet import PET

    seed_model = PET(hypers, energy_info())
    seed_model.init_weights(torch.Generator().manual_seed(0))
    return seed_model.module.state_dict()


def make_pet(dtype, plain, state, device, hypers=None, fused_gnn=False, int8_static=False,
             int8_scores=False):
    from metatrain_tpu_torch.models.pet import PET

    model = PET(hypers or {}, energy_info(), compute_dtype=dtype, plain=plain,
                fused_gnn=fused_gnn, int8_static=int8_static, int8_scores=int8_scores).to(device)
    model.module.load_state_dict(state)
    return model


def rel_errors(res, ref):
    e_rel = abs(res["energy"] - ref["energy"]) / abs(ref["energy"])
    f_rel = float(np.sqrt(np.mean((res["forces"] - ref["forces"]) ** 2))
                  / np.sqrt(np.mean(ref["forces"] ** 2)))
    return e_rel, f_rel


def profile_calls(fn, calls=2):
    """Device time per call of ``fn`` by kernel from a ``torch.profiler``
    trace of ``calls`` calls after a warm-up call, the device's busy time
    and its idle share of the host-clock time of the traced calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        kernels[evt.key] = (evt.self_cuda_time_total if us is None else us) / 1e3 / calls
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:24]
    return {"wall_ms_per_call": wall, "device_busy_ms_per_call": busy,
            "idle_share": 1.0 - busy / wall, "kernels_ms_per_call": dict(top)}


def time_force_calls(calcs, system, reps=5):
    """ms per force call and atom-steps/s of each calculator on ``system``:
    host clock around synchronised calls, each path warmed up; two rounds
    in opposite orders so that no path always runs first."""
    samples = {key: [] for key in calcs}
    for order in (list(calcs), list(calcs)[::-1]):
        for key in order:
            calcs[key].compute(system, forces=True, stress=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                calcs[key].compute(system, forces=True, stress=False)
            torch.cuda.synchronize()
            samples[key].append((time.perf_counter() - t0) / reps * 1e3)
    return {key: {"ms_per_force_call": float(np.mean(ms)), "rounds_ms": ms,
                  "atom_steps_per_s": len(system) / (float(np.mean(ms)) * 1e-3)}
            for key, ms in samples.items()}


def check_slice(device, hypers, expected, n_cells=14, steps=3, timing=True, fused_gnn=False,
                time_plain=True, state=None, calcs_out=None):
    """Serve the force call of PET with ``hypers`` (random weights, or
    ``state``; with ``fused_gnn``, each GNN layer as one block); returns
    its report, with the served batch's (A, M) under ``padded``.
    ``time_plain=False`` times the kernel paths only and skips the
    profile; ``calcs_out``, a dict, receives the four calculators."""
    from metatrain_tpu_torch.calculator import Calculator
    from metatrain_tpu_torch.containers import System
    from metatrain_tpu_torch.ops.kernels import _lib

    state = random_state(hypers) if state is None else state
    calcs = {
        f"{path}_{tag}": Calculator(make_pet(dtype, path == "plain", state, device, hypers,
                                             fused_gnn))
        for path, tag, dtype in (("kernel", "bf16", torch.bfloat16),
                                 ("kernel", "f32", torch.float32),
                                 ("plain", "f32", torch.float32),
                                 ("plain", "bf16", torch.bfloat16))
    }
    if calcs_out is not None:
        calcs_out.update(calcs)
    system = bench_crystal(n_cells)
    n = len(system)
    rng = np.random.default_rng(1)
    report = {"hypers": hypers, "atoms": n}

    # the served force calls: every counter starts at 0 here
    calc = calcs["kernel_bf16"]
    _lib.LAUNCHES.clear()
    _lib.CALLS.clear()
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
    report["calls"] = dict(_lib.CALLS)
    report["padded"] = [calc._last_batch.n_atoms_padded, calc._last_batch.max_neighbors]

    final = System(positions, system.types, system.cell, system.pbc)
    # the f32 kernel path's launches in one call: every counter at 0 here
    _lib.LAUNCHES.clear()
    _lib.CALLS.clear()
    results = {"kernel_f32": calcs["kernel_f32"].compute(final, forces=True, stress=True)}
    torch.cuda.synchronize()
    report["launches_f32_per_call"] = dict(_lib.LAUNCHES)
    report["calls_f32_per_call"] = dict(_lib.CALLS)
    results.update({k: c.compute(final, forces=True, stress=True) for k, c in calcs.items()
                    if k != "kernel_f32"})
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

    timed = calcs if time_plain else {k: c for k, c in calcs.items() if k.startswith("kernel")}
    report["timing"] = time_force_calls(timed, final)
    if time_plain:
        report["profile_kernel_bf16"] = profile_calls(
            lambda: calcs["kernel_bf16"].compute(final, forces=True))
    return report


# phase 3b: PET's physics options on the served call. (a) ZBL, Ewald long
# range and charge/spin conditioning (its zero-initialised gate drawn);
# (b) adaptive cutoffs (the solver) with PME long range
LONG_RANGE = {"enable": True, "smearing": 1.4, "n_kmax": 4, "method": "ewald", "mesh": 32}
PHYSICS = {
    "physics_a": {"zbl": True, "system_conditioning": True, "long_range": LONG_RANGE},
    "physics_b": {"num_neighbors_adaptive": 16, "adaptive_cutoff_method": "solver",
                  "long_range": {**LONG_RANGE, "method": "pme"}},
}
# the charge and spin multiplicity of the conditioned batches and frames
CHARGED = ({"charge": 1, "spin_multiplicity": 2}, {"charge": -1, "spin_multiplicity": 3})


def physics_state(hypers):
    """Random weights for ``hypers``, the conditioning gate drawn from a
    seeded generator (at zero it would hide the option)."""
    state = random_state(hypers)
    if hypers.get("system_conditioning"):
        key = "system_conditioning.gate.weight"
        state[key] = torch.randn(state[key].shape,
                                 generator=torch.Generator().manual_seed(3)) * 0.5
    return state


def check_hopper_launches(key, report):
    """A served bf16 call at d_pet 128: the Hopper K1 and K2 4 times per
    call and their general bodies never, the Hopper K3 and K4 2 times per
    call for the compress and the combination and once for the head."""
    launches, per_call = report["launches"], report["launches_per_call"]
    if (launches.get("fused_layer_fwd", 0) or launches.get("fused_layer_bwd", 0)
            or any(per_call.get(k) != 4 for k in ("fused_layer_fwd_sm90", "fused_layer_bwd_sm90"))):
        fail(f"{key}: the bf16 force calls launched {launches}: 4 Hopper K1 and 4 Hopper K2 "
             "per call expected")
    check_rowblock_launches(key, report, ROWBLOCK_SM90_PER_CALL)


def check_options_acted(key, hypers, calcs, report):
    """Each option of ``hypers`` changed the served call: ZBL's energy and
    the long-range features are non-zero, a batch with a charge and a spin
    gives another energy than the neutral singlet, the adaptive cutoffs lie
    in [0.5, cutoff] and are not the cutoff."""
    from metatrain_tpu_torch.containers import System, batch_from_systems
    from metatrain_tpu_torch.engine.evaluate import evaluate_model
    from metatrain_tpu_torch.ops.inference import no_param_grads
    from metatrain_tpu_torch.ops.neighbors import compute_neighbor_data

    calc = calcs["kernel_bf16"]
    model, batch = calc.model, calc._last_batch
    acted = {}
    with torch.no_grad():
        if model.zbl is not None:
            acted["zbl_energy"] = model.zbl.forward(batch, ["energy"])["energy"][0, 0].item()
            if not (math.isfinite(acted["zbl_energy"]) and acted["zbl_energy"] != 0):
                fail(f"{key}: ZBL energy {acted['zbl_energy']}")
        if model.num_neighbors_adaptive is not None:
            r = model.preprocess(batch)["atomic_cutoffs"][batch.atom_mask]
            acted["adaptive_cutoffs"] = [r.min().item(), r.mean().item(), r.max().item()]
            if not (0.5 <= r.min().item() and r.max().item() <= model.cutoff + 1e-6
                    and (model.cutoff - r).abs().max().item() > 0.01):
                fail(f"{key}: adaptive cutoffs {acted['adaptive_cutoffs']}")
    if model.module.long_range is not None:
        seen = []
        hook = model.module.long_range.register_forward_hook(
            lambda mod, args, out: seen.append(out.detach().float().abs().max()))
        calc.compute(bench_crystal(), forces=False)
        hook.remove()
        acted["long_range_max_abs"] = seen[0].item()
        if not (math.isfinite(acted["long_range_max_abs"]) and acted["long_range_max_abs"] > 0):
            fail(f"{key}: long-range features {acted['long_range_max_abs']}")
    if model.requested_extra_system_keys():
        crystal = bench_crystal()
        charged = System(crystal.positions, crystal.types, crystal.cell, crystal.pbc,
                         dict(CHARGED[0]))
        nbr = compute_neighbor_data(charged, model.cutoff)
        energies = []
        for keys in ((), model.requested_extra_system_keys()):
            b = batch_from_systems([charged], [nbr], batch.device, extra_keys=keys)
            with no_param_grads(model):
                energies.append(evaluate_model(model.forward_eval, b, {
                    "energy": energy_info().targets["energy"]})["energy"].block(0)
                    .values[0, 0].item())
        acted["energy_neutral_singlet"], acted["energy_charge_1_spin_2"] = energies
        if not all(map(math.isfinite, energies)) or energies[0] == energies[1]:
            fail(f"{key}: charge and spin did not change the energy: {energies}")
    report["acted"] = acted


def option_times(calcs):
    """ms of each option's own work in the served force call (its forward
    and its backward to the positions, CUDA events), on the served batch:
    ZBL, the long-range featurizer and the adaptive cutoffs; and whether
    two runs of the featurizer give the same bits (PME's spread and its
    gather's adjoint add with atomics)."""
    from metatrain_tpu_torch.models.pet.adaptive import get_adaptive_cutoffs

    model, batch = calcs["kernel_bf16"].model, calcs["kernel_bf16"]._last_batch
    pos = batch.positions.detach().requires_grad_(True)
    live = batch.replace(positions=pos)
    times = {}
    if model.zbl is not None:
        times["zbl_ms"] = cuda_ms(lambda: torch.autograd.grad(
            model.zbl.forward(live, ["energy"])["energy"].sum(), pos))
    lr = model.module.long_range
    if lr is not None:
        bd = model.preprocess(live)
        nf = torch.randn((batch.n_atoms_padded, model.hypers["d_node"]), device=pos.device,
                         generator=torch.Generator(pos.device).manual_seed(0)).to(lr.dtype)
        def featurize():
            out = lr(nf, bd)
            return out, torch.autograd.grad(out.float().sum(), pos, retain_graph=True)[0]

        times[f"long_range_{lr.method}_ms"] = cuda_ms(featurize)
        (o1, g1), (o2, g2) = featurize(), featurize()
        times["long_range_repeat_bitwise"] = bool(torch.equal(o1, o2) and torch.equal(g1, g2))
        times["long_range_repeat_max_abs_diff"] = max(
            (o1 - o2).abs().max().item(), (g1 - g2).abs().max().item())
    if model.num_neighbors_adaptive is not None:
        def solve():
            _, distances = live.edge_vectors()
            r = get_adaptive_cutoffs(distances, live.nbr_mask, float(model.num_neighbors_adaptive),
                                     model.cutoff, model.cutoff_width_adaptive)
            return torch.autograd.grad(r.sum(), pos)
        times["adaptive_solver_ms"] = cuda_ms(solve)
    return times


def check_cutoff_stats(calcs):
    """Phase 3c's ``mtt::aux::cutoff_stats`` of the adaptive model on its
    served batch, bf16 kernel path against the f32 plain path (both solve
    the cutoffs in the batch's float32): within 1e-5 relative, the cutoffs
    in [0.5, cutoff] and not all the cutoff."""
    from metatrain_tpu_torch.models.pet.model import CUTOFF_STATS

    batch = calcs["kernel_bf16"]._last_batch
    stats = {}
    for key in ("kernel_bf16", "plain_f32"):
        with torch.no_grad():
            block = calcs[key].model.forward(batch, [CUTOFF_STATS])[CUTOFF_STATS].block(0)
        stats[key] = block.values[batch.atom_mask].double()
    k, p = stats["kernel_bf16"], stats["plain_f32"]
    worst = float(((k - p).abs().max(dim=0).values / p.abs().max(dim=0).values).max())
    cutoff = calcs["kernel_bf16"].model.cutoff
    out = {"worst_rel": worst, "cutoff_min_mean_max": [k[:, 0].min().item(), k[:, 0].mean().item(),
                                                        k[:, 0].max().item()],
           "smooth_count_mean": k[:, 1].mean().item()}
    if not (worst <= 1e-5 and 0.5 <= out["cutoff_min_mean_max"][0]
            and out["cutoff_min_mean_max"][2] <= cutoff + 1e-6
            and out["cutoff_min_mean_max"][0] < cutoff - 0.01):
        fail(f"cutoff_stats of the adaptive model: {out}")
    return out


def physics_frames(path):
    """Phase 5's first two frames (the same generator), LJ-labelled, with a
    charge and a spin multiplicity each, as extended xyz."""
    from metatrain_tpu_torch.data.readers.extxyz import write_xyz

    rng = np.random.default_rng(2)
    frames = [fcc_frame(8, rng, 0.1) for _ in range(2)]
    labels = [lennard_jones(f) for f in frames]
    write_xyz(str(path), frames, per_atom_arrays=[{"forces": f} for _, f in labels],
              info=[{"energy": e, **q} for (e, _), q in zip(labels, CHARGED)])


def check_physics(device, report, workdir):
    """Phase 3b: each physics model served as phase 3 (the Hopper kernels'
    launches, its gates), its options shown to act, their own times, and
    one f32 training step, kernel vs plain, with phase 6's gates."""
    physics_frames(workdir / "cu_lj_charged.xyz")
    for key, hypers in PHYSICS.items():
        state = physics_state(hypers)
        calcs = {}
        report[key] = check_slice(device, hypers, FUSED_SM90_KERNELS, time_plain=key == "physics_b",
                                  state=state, calcs_out=calcs)
        check_hopper_launches(key, report[key])
        check_options_acted(key, hypers, calcs, report[key])
        report[key]["option_times"] = option_times(calcs)
        if hypers.get("num_neighbors_adaptive"):
            report[key]["cutoff_stats"] = check_cutoff_stats(calcs)
        del calcs
        torch.cuda.empty_cache()
        report[f"training_parity_{key}"] = check_training_parity(
            workdir / "cu_lj_charged.xyz", state, device, hypers,
            expected=(K1_F32, *K2DW_F32, *K3_F32, *K4DW_F32), replayed=("fused_layer",),
            absent=("fused_layer_fwd",) + K2DW_F32_NEVER + K4_F32_NEVER + K3_F32_NEVER,
            per_step={K1_F32: K1_F32_PER_STEP} | {k: K2DW_PER_STEP for k in K2DW_F32}
            | K4DW_F32_PER_STEP | K3_F32_PER_STEP)
        torch.cuda.empty_cache()


# phase 3c: generic targets on PET at its defaults. Targets (6): the energy
# with forces and virial, a 4-member ensemble with its own forces (LLPR's
# layout), per-atom charges, a dipole (Cartesian rank 1), a polarizability
# (spherical (0, 1) and (2, 1)) and the non-conservative stress; with the
# aux outputs ``features`` and the energy's last-layer features
ENSEMBLE = "mtt::energy_ensemble"
GENERIC_AUX = ("features", "mtt::aux::energy_last_layer_features")
POLAR_IRREPS = [{"o3_lambda": 0, "o3_sigma": 1}, {"o3_lambda": 2, "o3_sigma": 1}]
# the launches the code implies (a prediction, held to every run): per
# all-outputs call, one forward (the Hopper K1 4 times, K3's compress and
# combination 2 each, one K3 head per target: 6) and 5 backward passes
# (the energy's, then one per ensemble member), each with phase 3's
# backward (the Hopper K2 4 times, K4's compress and combination 2 each,
# the accumulate permute 2) and the K4 head of the target it seeds
GENERIC_PER_CALL = {
    "fused_layer_fwd_sm90": 4, "fused_layer_bwd_sm90": 20, "fused_layer_fwd": 0,
    "fused_layer_bwd": 0, "permute": 2, "permute_acc": 10,
    **{f"rowblock_{d}{v}[{s}]": n if v == "_sm90" else 0
       for d, per_stage in (("fwd", {"compress": 2, "combination": 2, "head": 6}),
                            ("bwd", {"compress": 10, "combination": 10, "head": 5}))
       for v in ("_sm90", "") for s, n in per_stage.items()},
}


def generic_info():
    """The DatasetInfo of phase 3c's targets."""
    from metatrain_tpu_torch.containers import Labels
    from metatrain_tpu_torch.data.target_info import (
        DatasetInfo,
        _empty_block,
        get_energy_target_info,
        get_generic_target_info,
    )

    ensemble = get_generic_target_info("scalar", num_properties=4, quantity="energy", unit="eV")
    block = ensemble.layout.block(0)
    block.add_gradient("positions", _empty_block(
        ["sample", "system", "atom"], [Labels(["xyz"], np.arange(3).reshape(-1, 1))],
        block.properties))
    return DatasetInfo("angstrom", [29], {
        "energy": get_energy_target_info("eV", True, True),
        ENSEMBLE: ensemble,
        "mtt::charges": get_generic_target_info("scalar", per_atom=True),
        "mtt::dipole": get_generic_target_info("cartesian", rank=1),
        "mtt::polarizability": get_generic_target_info("spherical", irreps=POLAR_IRREPS),
        "non_conservative_stress": get_generic_target_info("cartesian", rank=2),
    })


def served_batch(system, cutoff, device):
    """The calculator's batch of ``system``: the list at cutoff + 0.5 A
    skin, atoms and slots padded by its buckets (A = 11,392, M = 64 on the
    crystal)."""
    from metatrain_tpu_torch.containers import batch_from_systems, bucket_atoms, bucket_neighbors
    from metatrain_tpu_torch.ops.neighbors import VerletNeighborList

    nbr = VerletNeighborList(cutoff, 0.5).update(system)
    return batch_from_systems([system], [nbr], device, n_atoms_padded=bucket_atoms(len(system), 1.1),
                              n_systems_padded=2,
                              max_neighbors=bucket_neighbors(nbr.max_neighbors, 1.1),
                              dtype=torch.float32)


def generic_outputs(model, batch, infos, aux=GENERIC_AUX):
    """Every output of ``infos`` (forces, virial and the ensemble's forces
    attached) and the aux outputs, in one served call: ``{output/block/
    field: tensor}`` on the device."""
    from metatrain_tpu_torch.engine.evaluate import evaluate_model
    from metatrain_tpu_torch.ops.inference import no_param_grads

    with no_param_grads(model):
        preds = evaluate_model(model.forward_eval, batch, infos, outputs=list(infos) + list(aux))
    out = {}
    for name, tmap in preds.items():
        for b, block in enumerate(tmap.blocks()):
            out[f"{name}/{b}/values"] = block.values.detach()
            for gname, grad in block.gradients():
                out[f"{name}/{b}/{gname}"] = grad.values.detach()
    return out


def rel_rms(a, b):
    a, b = a.double(), b.double()
    return float(torch.sqrt(torch.mean((a - b) ** 2)) / torch.sqrt(torch.mean(b**2)))


def generic_errors(res, ref, n):
    """Energy relative error, forces and virial relative RMS, and every
    other output's relative RMS, of ``res`` against ``ref``."""
    errors = {}
    for key, value in ref.items():
        if key == "energy/0/values":
            errors["energy"] = float(abs(res[key][0, 0].double() - value[0, 0].double())
                                     / abs(value[0, 0].double()))
        elif key == "energy/0/positions":
            errors["forces"] = rel_rms(res[key][:n], value[:n])
        elif key == "energy/0/strain":
            errors["virial"] = rel_rms(res[key][0], value[0])
        else:
            errors[key] = rel_rms(res[key], value)
    return errors


def generic_frames(path):
    """Phase 5's first two frames with deterministic generic labels from
    their positions: the LJ energy and forces, per-atom charges from each
    atom's distance to the centre, their dipole, and a polarizability from
    the second moment of the positions (its trace and five traceless
    components)."""
    from metatrain_tpu_torch.data.readers.extxyz import write_xyz

    rng = np.random.default_rng(2)
    frames = [fcc_frame(8, rng, 0.1) for _ in range(2)]
    info, arrays = [], []
    for frame in frames:
        energy, forces = lennard_jones(frame)
        r = frame.positions - frame.positions.mean(0)
        charges = np.tanh(np.linalg.norm(r, axis=1) / 10.0)
        charges -= charges.mean()
        t = r.T @ r / len(r)
        polar = [np.trace(t) / 3, t[0, 1], t[1, 2], (2 * t[2, 2] - t[0, 0] - t[1, 1]) / 2,
                 t[0, 2], (t[0, 0] - t[1, 1]) / 2]
        info.append({"energy": energy, "dipole": charges @ r, "polarizability": np.array(polar)})
        arrays.append({"forces": forces, "charges": charges[:, None]})
    write_xyz(str(path), frames, per_atom_arrays=arrays, info=info)
    return frames


GENERIC_LOSS = {
    "energy": {"type": "mse", "weight": 1.0, "gradients": {"positions": {"weight": 10.0}}},
    "mtt::charges": {"type": "huber", "delta": 0.1},
    "mtt::dipole": "mae",
    "mtt::polarizability": "shift_agnostic_mse",
}


def generic_dataset_section(path):
    return {"systems": {"read_from": str(path), "length_unit": "angstrom"}, "targets": {
        "energy": {"key": "energy", "unit": "eV", "forces": "on"},
        "mtt::charges": {"key": "charges", "per_atom": True},
        "mtt::dipole": {"key": "dipole", "type": {"cartesian": {"rank": 1}}},
        "mtt::polarizability": {"key": "polarizability",
                                "type": {"spherical": {"irreps": POLAR_IRREPS}}}}}


def check_generic_training(path, device):
    """One f32 training step on the generic frames, kernel vs plain path,
    with phase 6's gates; both batches rotated by an O3 augmenter of seed
    0 (the same rotations: the Wigner D on the card's machine)."""
    from metatrain_tpu_torch.data.collate import CollateFn
    from metatrain_tpu_torch.data.dataset import get_dataset, get_dataset_info
    from metatrain_tpu_torch.engine.augmentation import O3Augmenter
    from metatrain_tpu_torch.engine.loss import LossAggregator
    from metatrain_tpu_torch.engine.trainer import _compute_loss_and_errors
    from metatrain_tpu_torch.models.pet import PET
    from metatrain_tpu_torch.ops.kernels import _lib
    from metatrain_tpu_torch.utils.config import expand_dataset_config

    dataset, infos = get_dataset(expand_dataset_config(generic_dataset_section(path)))
    info = get_dataset_info([dataset], infos, "angstrom")
    seed_model = PET({}, info)
    seed_model.init_weights(torch.Generator().manual_seed(0))
    state = seed_model.module.state_dict()
    results, report = {}, {}
    for key, plain in (("kernel", False), ("plain", True)):
        model = PET({}, info, compute_dtype=torch.float32, plain=plain).to(device)
        model.module.load_state_dict(state)
        batch = CollateFn(model.cutoff, infos, dtype=torch.float32, device=device,
                          transforms=[O3Augmenter(seed=0)])([dataset[0], dataset[1]])
        scales = {name: [torch.ones(1, device=device)] * len(i.layout) for name, i in infos.items()}
        params = [p for p in model.parameters() if p.requires_grad]
        if not plain:
            _lib.LAUNCHES.clear()
            _lib.REPLAYS.clear()
        loss, _ = _compute_loss_and_errors(model, LossAggregator(infos, GENERIC_LOSS), infos, [],
                                           scales, batch, True)
        grads = torch.autograd.grad(loss, params)
        if not plain:
            torch.cuda.synchronize()
            report["launches"], report["replays"] = dict(_lib.LAUNCHES), dict(_lib.REPLAYS)
        results[key] = (loss.detach(), [g.detach() for g in grads],
                        [n for n, p in model.named_parameters() if p.requires_grad],
                        batch.targets["mtt::polarizability"].block(1).values.detach())
        del model, batch, params
        torch.cuda.empty_cache()
    (lk, gk, names, polar_k), (lp, gp, _, polar_p) = results["kernel"], results["plain"]
    launches = report["launches"]
    # the Hopper float32 K1 (4) and never the general K1, the Hopper
    # float32 K3 and never the general K3, K2-dW and K4-dW; a Hopper float32
    # K3 head per target and at least one Hopper float32 K4-dW head per target
    check_k2dw_launches(launches, per_step=K2DW_PER_STEP)
    check_k4dw_launches(launches)
    missing = [k for k in (K1_F32, *K3_F32) if not launches.get(k)]
    if (missing or launches.get(K1_F32) != K1_F32_PER_STEP or launches.get("fused_layer_fwd", 0)
            or launches.get("rowblock_fwd_f32_sm90[head]") != len(infos)
            or launches.get("rowblock_bwd_dw_f32_sm90[head]", 0) < len(infos)):
        fail(f"generic training step launched {launches}; missing {missing}, expected "
             f"{K1_F32_PER_STEP} Hopper float32 K1 and no general K1, {len(infos)} f32 K3 heads "
             f"and at least {len(infos)} f32 K4-dW heads")
    if not torch.equal(polar_k, polar_p):
        fail("the two paths' augmented polarizabilities differ")
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    flat_k, flat_p = torch.cat([g.flatten() for g in gk]), torch.cat([g.flatten() for g in gp])
    global_rel = ((flat_k - flat_p).norm() / flat_p.norm()).item()
    per_tensor = {n: ((a - b).norm() / b.norm()).item() if b.norm() > 0 else (a - b).norm().item()
                  for n, a, b in zip(names, gk, gp)}
    worst = max(per_tensor, key=per_tensor.get)
    report.update({"loss_kernel": lk.item(), "loss_plain": lp.item(), "loss_rel": loss_rel,
                   "grad_global_rel_l2": global_rel, "grad_worst_tensor": worst,
                   "grad_worst_tensor_rel_l2": per_tensor[worst]})
    if not (loss_rel <= 1e-5 and global_rel <= 1e-4 and per_tensor[worst] <= 1e-3):
        fail(f"generic training step, f32 kernel vs plain: {report}")
    return report


def check_member_gradients(model, batch, res):
    """Each ensemble member's position gradient from the all-outputs call
    (one backward pass per member) equals, to 1e-6 relative, a call that
    seeds that member alone."""
    from metatrain_tpu_torch.containers import TensorBlock, TensorMap
    from metatrain_tpu_torch.data.target_info import get_energy_target_info
    from metatrain_tpu_torch.engine.evaluate import evaluate_model
    from metatrain_tpu_torch.ops.inference import no_param_grads

    info = get_energy_target_info("eV", add_position_gradients=True)
    worst = 0.0
    for p in range(4):
        def member(b, names, p=p):
            out = model.forward_eval(b, [ENSEMBLE])[ENSEMBLE]
            block = out.block(0)
            return {"m": TensorMap(out.keys, [TensorBlock(
                block.values[:, p:p + 1], block.samples, [], info.layout.block(0).properties,
                block.mask)])}

        with no_param_grads(model):
            alone = evaluate_model(member, batch, {"m": info})["m"].block(0)
        ref = res[f"{ENSEMBLE}/0/positions"][..., p].double()
        diff = (alone.gradient("positions").values[..., 0].double() - ref).abs().max()
        worst = max(worst, float(diff / ref.abs().max()))
    if not worst <= 1e-6:
        fail(f"ensemble member gradients differ from single-member calls by {worst:.3g}")
    return worst


def time_generic_calls(model, batch, infos, reps=5):
    """ms per call and atom-steps/s (host clock around synchronised calls,
    after a warm-up) of the all-outputs call, of the same without the
    ensemble's forces (the property loop's four backward passes), and of
    phase 3's energy-only force call, on one model and batch, two rounds in
    opposite orders."""
    from metatrain_tpu_torch.data.target_info import (
        get_energy_target_info,
        get_generic_target_info,
    )

    no_ensemble_forces = dict(infos, **{ENSEMBLE: get_generic_target_info(
        "scalar", num_properties=4, quantity="energy", unit="eV")})
    calls = {
        "all_outputs": lambda: generic_outputs(model, batch, infos),
        "all_outputs_no_ensemble_forces": lambda: generic_outputs(model, batch,
                                                                  no_ensemble_forces),
        "energy_forces_only": lambda: generic_outputs(
            model, batch, {"energy": get_energy_target_info("eV", True)}, aux=()),
    }
    samples = {key: [] for key in calls}
    for order in (list(calls), list(calls)[::-1]):
        for key in order:
            calls[key]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                calls[key]()
            torch.cuda.synchronize()
            samples[key].append((time.perf_counter() - t0) / reps * 1e3)
    n = int(batch.atom_mask.sum())
    out = {key: {"ms_per_call": float(np.mean(ms)), "rounds_ms": ms,
                 "atom_steps_per_s": n / (float(np.mean(ms)) * 1e-3)}
           for key, ms in samples.items()}
    out["property_loop_ms"] = (out["all_outputs"]["ms_per_call"]
                               - out["all_outputs_no_ensemble_forces"]["ms_per_call"])
    return out


def check_generic_eval(model, frames_path, device, workdir):
    """``__main__.main(["eval", ...])`` in this process on the model saved
    as ``generic.mtt`` and the two frames: its ``preds.xyz`` read back
    equals the in-process predictions (f32 kernel path) of the same
    file's model, to 1e-5 relative."""
    import os

    from metatrain_tpu_torch.__main__ import main as cli
    from metatrain_tpu_torch.cli.export import export_model_object
    from metatrain_tpu_torch.containers import batch_from_systems
    from metatrain_tpu_torch.data.readers.extxyz import read_xyz
    from metatrain_tpu_torch.data.writers import xyz_column
    from metatrain_tpu_torch.ops.neighbors import compute_neighbor_data
    from metatrain_tpu_torch.utils.io import load_model

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        export_model_object(model, None, "generic.mtt")
        Path("generic_eval.json").write_text(json.dumps(generic_dataset_section(frames_path)))
        if cli(["eval", "generic.mtt", "generic_eval.json", "-o", "generic_preds.xyz",
                "--device", str(device)]) not in (0, None):
            fail("the eval command failed on the generic model")
        written = read_xyz("generic_preds.xyz")
        loaded = load_model("generic.mtt", device=device)
        infos = {n: i for n, i in loaded.supported_outputs().items()
                 if n in generic_dataset_section(frames_path)["targets"]}
        worst = 0.0
        for index, system in enumerate(read_xyz(str(frames_path))):
            nbr = compute_neighbor_data(system, loaded.requested_neighbor_cutoff())
            batch = batch_from_systems([system], [nbr], device, dtype=torch.float32)
            res = generic_outputs(loaded, batch, infos, aux=())
            n = len(system)
            got = written[index]
            pairs = {
                "energy": (got.extra["energy"], res["energy/0/values"][0, 0]),
                "forces": (got.extra[xyz_column("energy_forces")],
                           -res["energy/0/positions"][:n, :, 0]),
                "charges": (got.extra[xyz_column("mtt::charges")],
                            res["mtt::charges/0/values"][:n, 0]),
                "dipole": (got.extra["mtt::dipole"], res["mtt::dipole/0/values"][0]),
                "polarizability": (got.extra["mtt::polarizability"], torch.cat(
                    [res[f"mtt::polarizability/{b}/values"][0].reshape(-1) for b in (0, 1)])),
            }
            for key, (file_value, value) in pairs.items():
                value = value.double().cpu().numpy().reshape(-1)
                file_value = np.asarray(file_value, dtype=np.float64).reshape(-1)
                if file_value.shape != value.shape:
                    fail(f"eval wrote {key} of shape {file_value.shape}, expected {value.shape}")
                worst = max(worst, float(np.abs(file_value - value).max()
                                         / max(np.abs(value).max(), 1e-30)))
        if not worst <= 1e-5:
            fail(f"eval's preds.xyz differs from the in-process predictions by {worst:.3g}")
        return {"worst_rel": worst, "systems": len(written)}
    finally:
        os.chdir(cwd)


def check_generic(device, report, workdir):
    """Phase 3c: PET at its defaults with phase 3c's targets on the
    crystal, served in bf16 (all outputs in one call) against the f32
    plain path, with the launch counts held to ``GENERIC_PER_CALL``; the
    ensemble members' gradients against single-member calls; the times;
    one f32 training step on generic labels; the cutoff statistics of
    phase 3b's adaptive model (in ``check_physics``); the eval command's
    round trip."""
    from metatrain_tpu_torch.models.pet import PET
    from metatrain_tpu_torch.ops.kernels import _lib

    info = generic_info()
    infos = dict(info.targets)
    seed_model = PET({}, info)
    seed_model.init_weights(torch.Generator().manual_seed(0))
    state = seed_model.module.state_dict()
    models = {}
    for path, tag, dtype in (("kernel", "bf16", torch.bfloat16), ("kernel", "f32", torch.float32),
                             ("plain", "f32", torch.float32), ("plain", "bf16", torch.bfloat16)):
        model = PET({}, info, compute_dtype=dtype, plain=path == "plain").to(device)
        model.module.load_state_dict(state)
        models[f"{path}_{tag}"] = model
    crystal = bench_crystal()
    n = len(crystal)
    batch = served_batch(crystal, models["kernel_bf16"].cutoff, device)
    out = {"padded": [batch.n_atoms_padded, batch.max_neighbors]}

    # the served all-outputs calls: every counter starts at 0 here
    steps = 2
    _lib.LAUNCHES.clear()
    for _ in range(steps):
        res = generic_outputs(models["kernel_bf16"], batch, infos)
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    per_call = {k: launches.get(k, 0) / steps for k in GENERIC_PER_CALL}
    out["launches"], out["launches_per_call"] = launches, per_call
    out["launches_predicted"] = GENERIC_PER_CALL
    if per_call != {k: float(v) for k, v in GENERIC_PER_CALL.items()}:
        fail(f"generic targets: launches per call {per_call}, predicted {GENERIC_PER_CALL}")
    for key, value in res.items():
        if not torch.isfinite(value).all():
            fail(f"generic targets: {key} not finite")
    if res["non_conservative_stress/0/values"][0].abs().max() == 0:
        fail("generic targets: the non-conservative stress is zero")

    results = {key: generic_outputs(m, batch, infos) for key, m in models.items()}
    bf16 = generic_errors(results["kernel_bf16"], results["plain_f32"], n)
    f32 = generic_errors(results["kernel_f32"], results["plain_f32"], n)
    bf16_plain = generic_errors(results["plain_bf16"], results["plain_f32"], n)
    out["errors"] = {"bf16_kernel_vs_f32_plain": bf16, "f32_kernel_vs_f32_plain": f32,
                     "bf16_plain_vs_f32_plain": bf16_plain}
    # bf16: phase 3's rule for energy (1 %), forces and virial (5 %), 5 %
    # relative RMS for every other output, or 1.25 x the bf16 plain path's
    # own error where that is larger; f32: 1e-5 (energy), 1e-4 (the rest)
    for key, err in bf16.items():
        bound = max(1e-2 if key == "energy" else 5e-2, 1.25 * bf16_plain[key])
        if not err <= bound:
            fail(f"generic targets, bf16 kernel vs f32 plain: {key} {err:.3g} > {bound:.3g}")
    for key, err in f32.items():
        if not err <= (1e-5 if key == "energy" else 1e-4):
            fail(f"generic targets, f32 kernel vs f32 plain: {key} {err:.3g}")
    out["member_gradients_worst_rel"] = check_member_gradients(
        models["kernel_f32"], batch, results["kernel_f32"])
    del results, res
    for key in ("kernel_f32", "plain_f32", "plain_bf16"):
        del models[key]
    torch.cuda.empty_cache()
    out["timing"] = time_generic_calls(models["kernel_bf16"], batch, infos)
    del models
    torch.cuda.empty_cache()

    frames_path = workdir / "cu_generic.xyz"
    generic_frames(frames_path)
    out["training_parity"] = check_generic_training(frames_path, device)
    torch.cuda.empty_cache()
    eval_model = PET({}, info, compute_dtype=torch.float32).to(device)
    eval_model.module.load_state_dict(state)
    eval_model.weights_initialized = True
    out["eval_round_trip"] = check_generic_eval(eval_model, frames_path, device, workdir)
    del eval_model
    torch.cuda.empty_cache()
    report["generic"] = out


# the served W8A8 call's K1-W8A8 and K2-W8A8: the Hopper K1 and K2's W8A8
# mode; the general W8A8 bodies and the exact kernels never there
W8A8_SM90 = ("fused_layer_fwd_w8a8_sm90", "fused_layer_bwd_w8a8_sm90")
W8A8_NEVER = ("fused_layer_fwd_w8a8", "fused_layer_bwd_w8a8", "fused_layer_fwd", "fused_layer_bwd",
              "fused_layer_fwd_sm90", "fused_layer_bwd_sm90")
W8A8_KERNELS = [*W8A8_SM90, "permute", "permute_acc"] + ROWBLOCK_SM90_KERNELS


def mae_terms(res, ref, n):
    """``bench.py``'s MAE-gate terms of ``res`` against ``ref`` (eV, A):
    energy and virial meV/atom, forces meV/A, beside their relative errors."""
    e_rel, f_rel = rel_errors(res, ref)
    return {"energy_mev_per_atom": abs(res["energy"] - ref["energy"]) / n * 1e3,
            "force_mev_per_ang": float(np.abs(res["forces"] - ref["forces"]).mean() * 1e3),
            "virial_mev_per_atom": float(np.abs(res["virial"] - ref["virial"]).sum() / n * 1e3),
            "energy_rel": e_rel, "force_rel_rmse": f_rel}


def check_w8a8_slice(device, make, steps=3, timing=True):
    """Serve the static W8A8 force call: ``make(dtype, plain, int8_static)``
    builds PET (the same weights each time). The W8A8 kernel model is
    calibrated on the served batch of the 10,976-atom crystal (its
    calibration carried to the W8A8 plain model); every counter starts at 0
    just before its served calls, where the Hopper K1-W8A8 and K2-W8A8
    (``W8A8_SM90``) must launch 4 times per call and the general W8A8
    bodies and the exact K1/K2 (``W8A8_NEVER``) never. Gates: finite outputs; W8A8 kernel vs
    W8A8 plain energy rel <= 1 %, force rel-RMSE <= 5 %; the W8A8 forces
    differ from the exact bf16 kernel path's. Reported: both bf16 paths'
    errors against the f32 exact plain path and, with ``timing``, ms per
    call of both and a profile of the W8A8 call."""
    from metatrain_tpu_torch.calculator import Calculator
    from metatrain_tpu_torch.containers import System
    from metatrain_tpu_torch.interop.jax_params import int8_calib_from_jax, int8_calib_to_jax
    from metatrain_tpu_torch.ops.kernels import _lib

    system = bench_crystal()
    n = len(system)
    calcs = {"exact_kernel_bf16": Calculator(make(torch.bfloat16, False, False)),
             "exact_plain_f32": Calculator(make(torch.float32, True, False))}
    # the calculator's padded batch of the crystal, which calibration takes
    calcs["exact_kernel_bf16"].compute(system, forces=True, stress=True)
    batch = calcs["exact_kernel_bf16"]._last_batch
    w8_kernel, w8_plain = make(torch.bfloat16, False, True), make(torch.bfloat16, True, True)
    n_cal = w8_kernel.calibrate_int8(batch)
    int8_calib_from_jax(w8_plain, int8_calib_to_jax(w8_kernel))
    calcs["w8a8_kernel_bf16"], calcs["w8a8_plain_bf16"] = Calculator(w8_kernel), Calculator(w8_plain)
    report = {"atoms": n, "layers_calibrated": n_cal,
              "calibration": int8_calib_to_jax(w8_kernel)}

    # the served force calls: every counter starts at 0 here
    calc = calcs["w8a8_kernel_bf16"]
    rng = np.random.default_rng(1)
    _lib.LAUNCHES.clear()
    positions = system.positions.copy()
    for _ in range(steps):
        res = calc.compute(System(positions, system.types, system.cell, system.pbc),
                           forces=True, stress=True)
        if not (math.isfinite(res["energy"]) and res["forces"].shape == (n, 3)
                and all(np.isfinite(res[k]).all() for k in ("forces", "stress", "virial"))):
            fail("W8A8 force call: non-finite output or forces of the wrong shape")
        positions = positions + rng.normal(0.0, 0.01, positions.shape)
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    per_call = {k: v / steps for k, v in launches.items()}
    missing = [k for k in W8A8_KERNELS if launches.get(k, 0) == 0]
    if (missing or any(launches.get(k, 0) for k in W8A8_NEVER)
            or any(per_call.get(k) != 4 for k in W8A8_SM90)):
        fail(f"the W8A8 force calls launched {launches} (not launched: {missing})")
    report.update(launches=launches, launches_per_call=per_call,
                  padded=[calc._last_batch.n_atoms_padded, calc._last_batch.max_neighbors])

    final = System(positions, system.types, system.cell, system.pbc)
    results = {k: c.compute(final, forces=True, stress=True) for k, c in calcs.items()}
    for key, res in results.items():
        if not (math.isfinite(res["energy"]) and np.isfinite(res["forces"]).all()
                and np.isfinite(res["virial"]).all()):
            fail(f"{key}: non-finite output")
    e_kp, f_kp = rel_errors(results["w8a8_kernel_bf16"], results["w8a8_plain_bf16"])
    _, f_q = rel_errors(results["w8a8_kernel_bf16"], results["exact_kernel_bf16"])
    ref = results["exact_plain_f32"]
    report["parity"] = {
        "w8a8_kernel_vs_w8a8_plain": {"energy_rel": e_kp, "force_rel_rmse": f_kp},
        "w8a8_kernel_vs_exact_bf16_kernel_force_rel_rmse": f_q,
        "w8a8_kernel_vs_f32_plain": mae_terms(results["w8a8_kernel_bf16"], ref, n),
        "w8a8_plain_vs_f32_plain": mae_terms(results["w8a8_plain_bf16"], ref, n),
        "exact_bf16_kernel_vs_f32_plain": mae_terms(results["exact_kernel_bf16"], ref, n),
        "energy_f32_plain": ref["energy"],
    }
    if not (e_kp <= 1e-2 and f_kp <= 5e-2):
        fail(f"W8A8 kernel path vs W8A8 plain: energy {e_kp:.3g}, forces {f_kp:.3g}")
    if not f_q > 1e-4:
        fail(f"the W8A8 forces equal the exact bf16 path's (rel-RMSE {f_q:.3g}): no quantization")
    if not timing:
        return report

    report["timing"] = time_force_calls(
        {key: calcs[key] for key in ("w8a8_kernel_bf16", "exact_kernel_bf16")}, final)
    report["profile_w8a8_kernel_bf16"] = profile_calls(
        lambda: calcs["w8a8_kernel_bf16"].compute(final, forces=True))
    return report


# the served int8 call's K1-int8 and K2-int8: the Hopper K1 and K2's
# int8-score mode, their scales from the Hopper absmax pass; the general
# bodies, the general pass and the exact kernels never there
INT8_SM90 = ("fused_layer_fwd_int8_sm90", "fused_layer_bwd_int8_sm90")
INT8_NEVER = ("int8_absmax", "fused_layer_fwd_int8", "fused_layer_bwd_int8", "fused_layer_fwd",
              "fused_layer_bwd", "fused_layer_fwd_sm90", "fused_layer_bwd_sm90")
INT8_KERNELS = ["int8_absmax_sm90", *INT8_SM90, "permute", "permute_acc"] + ROWBLOCK_SM90_KERNELS


def check_int8_slice(device, state, steps=3):
    """Serve the dynamic int8 scores' force call (PET at its defaults with
    ``int8_scores=True``, bfloat16) on the 10,976-atom crystal: every
    counter starts at 0 just before its served calls, where the Hopper
    absmax pass and the Hopper K1-int8 and K2-int8 must launch 4 times per
    call each (2 GNN x 2 layers), the general pass, the general int8 bodies
    and K1/K2 never. Gates: finite outputs; the int8 kernel path vs
    its plain path (both bf16) energy rel <= 1 %, force rel-RMSE <= 5 %; the
    int8 forces differ from the exact bf16 kernel path's (rel-RMSE > 1e-4).
    Reported: both bf16 paths' errors against the f32 exact plain path,
    relative and in ``bench.py``'s MAE terms; ms per call of the int8 and
    exact bf16 kernel paths; a profile of the int8 call."""
    from metatrain_tpu_torch.calculator import Calculator
    from metatrain_tpu_torch.containers import System
    from metatrain_tpu_torch.ops.kernels import _lib

    system = bench_crystal()
    n = len(system)
    calcs = {
        "int8_kernel_bf16": Calculator(make_pet(torch.bfloat16, False, state, device,
                                                int8_scores=True)),
        "int8_plain_bf16": Calculator(make_pet(torch.bfloat16, True, state, device,
                                               int8_scores=True)),
        "exact_kernel_bf16": Calculator(make_pet(torch.bfloat16, False, state, device)),
        "exact_plain_f32": Calculator(make_pet(torch.float32, True, state, device)),
    }
    calc = calcs["int8_kernel_bf16"]
    rng = np.random.default_rng(1)
    calc.compute(system, forces=True)  # the neighbor list, outside the counted calls
    torch.cuda.synchronize()
    # the served force calls: every counter starts at 0 here
    _lib.LAUNCHES.clear()
    positions = system.positions.copy()
    for _ in range(steps):
        res = calc.compute(System(positions, system.types, system.cell, system.pbc),
                           forces=True, stress=True)
        if not (math.isfinite(res["energy"]) and res["forces"].shape == (n, 3)
                and all(np.isfinite(res[k]).all() for k in ("forces", "stress", "virial"))):
            fail("int8 force call: non-finite output or forces of the wrong shape")
        positions = positions + rng.normal(0.0, 0.01, positions.shape)
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    per_call = {k: v / steps for k, v in launches.items()}
    missing = [k for k in INT8_KERNELS if launches.get(k, 0) == 0]
    if (missing or any(launches.get(k, 0) for k in INT8_NEVER)
            or any(per_call.get(k) != 4 for k in INT8_KERNELS[:3])):
        fail(f"the int8 force calls launched {launches} (not launched: {missing})")
    report = {"atoms": n, "launches": launches, "launches_per_call": per_call,
              "padded": [calc._last_batch.n_atoms_padded, calc._last_batch.max_neighbors]}

    final = System(positions, system.types, system.cell, system.pbc)
    results = {k: c.compute(final, forces=True, stress=True) for k, c in calcs.items()}
    for key, res in results.items():
        if not (math.isfinite(res["energy"]) and np.isfinite(res["forces"]).all()
                and np.isfinite(res["virial"]).all()):
            fail(f"{key}: non-finite output")
    e_kp, f_kp = rel_errors(results["int8_kernel_bf16"], results["int8_plain_bf16"])
    _, f_q = rel_errors(results["int8_kernel_bf16"], results["exact_kernel_bf16"])
    ref = results["exact_plain_f32"]
    report["parity"] = {
        "int8_kernel_vs_int8_plain": {"energy_rel": e_kp, "force_rel_rmse": f_kp},
        "int8_kernel_vs_exact_bf16_kernel_force_rel_rmse": f_q,
        "int8_kernel_vs_f32_plain": mae_terms(results["int8_kernel_bf16"], ref, n),
        "int8_plain_vs_f32_plain": mae_terms(results["int8_plain_bf16"], ref, n),
        "exact_bf16_kernel_vs_f32_plain": mae_terms(results["exact_kernel_bf16"], ref, n),
        "energy_f32_plain": ref["energy"],
    }
    if not (e_kp <= 1e-2 and f_kp <= 5e-2):
        fail(f"int8 kernel path vs int8 plain: energy {e_kp:.3g}, forces {f_kp:.3g}")
    if not f_q > 1e-4:
        fail(f"the int8 forces equal the exact bf16 path's (rel-RMSE {f_q:.3g}): no quantization")
    report["timing"] = time_force_calls(
        {key: calcs[key] for key in ("int8_kernel_bf16", "exact_kernel_bf16")}, final)
    report["profile_int8_kernel_bf16"] = profile_calls(
        lambda: calcs["int8_kernel_bf16"].compute(final, forces=True))
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
    expected = [K1_F32, *K2DW_F32, *K4DW_F32, *K3_F32]
    missing = [k for k in expected if launches.get(k, 0) == 0]
    if missing or launches.get("fused_layer_fwd", 0):
        fail(f"kernels not launched in the training run: {missing}, or the general K1 launched: "
             f"{launches.get('fused_layer_fwd', 0)}")
    check_k2dw_launches(launches)
    check_k4dw_launches(launches)
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


def training_setup(path, state, plain, device, samples, hypers=None, fused_gnn=False,
                   dtype=torch.float32, int8_scores=False):
    """A PET in ``dtype`` (kernel or plain path) with ``state``, its
    parameters, loss function and one collated batch of ``samples``."""
    from metatrain_tpu_torch.data.collate import CollateFn
    from metatrain_tpu_torch.data.dataset import get_dataset, get_dataset_info
    from metatrain_tpu_torch.engine.loss import LossAggregator
    from metatrain_tpu_torch.engine.trainer import _compute_loss_and_errors
    from metatrain_tpu_torch.models.pet import PET
    from metatrain_tpu_torch.utils.config import expand_dataset_config

    dataset, infos = get_dataset(expand_dataset_config(dataset_section(path)))
    info = get_dataset_info([dataset], infos, "angstrom")
    model = PET(hypers or {}, info, compute_dtype=dtype, plain=plain,
                fused_gnn=fused_gnn, int8_scores=int8_scores).to(device)
    model.module.load_state_dict(state)
    batch = CollateFn(model.cutoff, infos, dtype=torch.float32, device=device,
                      extra_system_keys=model.requested_extra_system_keys())(
        [dataset[i] for i in samples])
    loss_agg = LossAggregator(infos, TRAIN_LOSS)
    scales = {"energy": [torch.ones(1, device=device)]}

    def loss_and_errors(b, is_training):
        return _compute_loss_and_errors(model, loss_agg, infos, [], scales, b, is_training)

    params = [p for p in model.parameters() if p.requires_grad]
    n_atoms = int(batch.systems.atom_mask.sum())
    return model, params, loss_and_errors, batch, n_atoms


def check_training_parity(path, state, device, hypers=None, expected=(), replayed=(),
                          fused_gnn=False, int8_scores=False, dtype=torch.float32, absent=(),
                          per_step=None):
    """One step's loss and gradients: float32 kernel path vs plain path.
    Every counter starts at 0 before the kernel path's step; the kernels
    ``expected`` must launch in it (``per_step``: exactly so many times
    each of those it names), those ``absent`` must not, and the ops
    ``replayed`` must run their second-order replay. In bfloat16 (``dtype``,
    always with ``int8_scores``, the dynamic int8 scores): gates of loss rel
    <= 2e-2 and global gradient rel L2 <= 0.1 (both paths round to bf16 at
    their own places; the worst tensor is reported)."""
    from metatrain_tpu_torch.ops.kernels import _lib

    if int8_scores:
        dtype = torch.bfloat16
    results, report = {}, {}
    for key, plain in (("kernel", False), ("plain", True)):
        model, params, loss_fn, batch, _ = training_setup(
            path, state, plain, device, [0, 1], hypers, fused_gnn, dtype, int8_scores)
        if not plain:
            _lib.LAUNCHES.clear()
            _lib.REPLAYS.clear()
            _lib.CALLS.clear()
        loss, _ = loss_fn(batch, True)
        grads = torch.autograd.grad(loss, params)
        if not plain:
            torch.cuda.synchronize()
            report["launches"], report["replays"] = dict(_lib.LAUNCHES), dict(_lib.REPLAYS)
            report["calls"] = dict(_lib.CALLS)
            missing = [k for k in expected if _lib.LAUNCHES.get(k, 0) == 0]
            missing += [f"replay {k}" for k in replayed if _lib.REPLAYS.get(k, 0) == 0]
            if missing:
                fail(f"not run in the training step: {missing}")
            ran = [k for k in absent if _lib.LAUNCHES.get(k, 0)]
            if ran:
                fail(f"launched in the training step, expected never: {ran}")
            wrong = {k: _lib.LAUNCHES.get(k, 0) for k, n in (per_step or {}).items()
                     if _lib.LAUNCHES.get(k, 0) != n}
            if wrong:
                fail(f"launches in the training step {wrong}, expected {per_step}")
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
    finite = all(torch.isfinite(g).all() for g in gk)
    if dtype == torch.bfloat16:
        if not (finite and loss_rel <= 2e-2 and global_rel <= 0.1):
            fail(f"bf16 training step (int8 scores: {int8_scores}), kernel vs plain: {report}")
    elif not (loss_rel <= 1e-5 and global_rel <= 1e-4 and per_tensor[worst_name] <= 1e-3):
        fail(f"training step, f32 kernel vs plain: {report}")
    return report


def time_training(workdir, state, device, report, steps=3):
    """ms per training step, atom-steps/s and peak device memory; a
    profile of one step of each kernel path on 2 x 2,048 atoms."""
    from metatrain_tpu_torch.engine.trainer import make_optimizer, train_step
    from metatrain_tpu_torch.ops.kernels import _lib

    bench_path = workdir / "bench_lj.xyz"
    write_labelled(bench_path, [bench_crystal()])
    timing = {}
    for key, path, plain, samples, fused_gnn in (
        ("kernel_f32_2x2048", workdir / "cu_lj.xyz", False, [0, 1], False),
        ("plain_f32_2x2048", workdir / "cu_lj.xyz", True, [0, 1], False),
        ("kernel_gnn_block_f32_2x2048", workdir / "cu_lj.xyz", False, [0, 1], True),
        ("kernel_f32_10976", bench_path, False, [0], False),
    ):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        model, params, loss_fn, batch, n_atoms = training_setup(path, state, plain, device, samples,
                                                                fused_gnn=fused_gnn)
        optimizer = make_optimizer(params, None)
        train_step(params, optimizer, loss_fn, batch, 1e-5, 1.0)  # warm-up
        torch.cuda.synchronize()
        _lib.LAUNCHES.clear()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, _ = train_step(params, optimizer, loss_fn, batch, 1e-5, 1.0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        if fused_gnn:
            want = {k: n * steps for k, n in GNN_F32_PER_STEP.items()}
            if {k: _lib.LAUNCHES.get(k, 0) for k in want} != want or any(
                    _lib.LAUNCHES.get(k, 0) for k in GNN_GENERAL):
                fail(f"{key}: the timed steps launched {dict(_lib.LAUNCHES)}: {want} expected")
        elif key.startswith("kernel"):
            check_k2dw_launches(dict(_lib.LAUNCHES), per_step=K2DW_PER_STEP * steps)
            check_k4dw_launches(dict(_lib.LAUNCHES), steps)
            if (_lib.LAUNCHES.get(K1_F32) != K1_F32_PER_STEP * steps
                    or _lib.LAUNCHES.get("fused_layer_fwd", 0)):
                fail(f"{key}: the timed steps launched {dict(_lib.LAUNCHES)}: "
                     f"{K1_F32_PER_STEP} Hopper float32 K1 a step and no general K1 expected")
        if not math.isfinite(loss.item()):
            fail(f"{key}: training loss not finite")
        timing[key] = {"ms_per_step": ms, "atoms": n_atoms,
                       "atom_steps_per_s": n_atoms / (ms * 1e-3),
                       "max_memory_allocated_gb": torch.cuda.max_memory_allocated(device) / 1e9}
        if key.startswith("kernel") and key.endswith("2x2048"):
            timing[key]["profile"] = profile_calls(
                lambda: train_step(params, optimizer, loss_fn, batch, 1e-5, 1.0), calls=1)
        del model, params, optimizer, batch, loss
    torch.cuda.empty_cache()
    report["training_timing"] = timing


FS = 0.09822694788464063  # one femtosecond in ASE time units (eV, A, amu)
MD_EPOCHS = 30


class CapturedLog:
    """The messages of the logger ``name`` while the block runs."""

    def __init__(self, name):
        import logging

        self.logger, self.messages = logging.getLogger(name), []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def logged_metrics(messages, prefix=""):
    """``{key: value}`` of the logged ``<prefix><key>: <value>`` lines."""
    out = {}
    for message in messages:
        key, sep, value = message.rpartition(": ")
        if sep and key.startswith(prefix):
            try:
                out[key[len(prefix):]] = float(value)
            except ValueError:
                pass
    return out


def check_entry_points(device, report, workdir):
    """Phase 7b: the user's entry points, ``python -m metatrain_tpu_torch``
    called in this process (``__main__.main``), on phase 5's frames; then
    ``Calculator`` from the exported file and ``run_md_nve`` on the crystal."""
    import csv
    import glob
    import os

    from metatrain_tpu_torch.__main__ import main as cli
    from metatrain_tpu_torch.calculator import Calculator
    from metatrain_tpu_torch.cli.eval import eval_model
    from metatrain_tpu_torch.containers import batch_from_systems, bucket_atoms, bucket_neighbors
    from metatrain_tpu_torch.interop.jax_params import pet_from_checkpoint
    from metatrain_tpu_torch.ops.kernels import _lib
    from metatrain_tpu_torch.ops.neighbors import compute_neighbor_data
    from metatrain_tpu_torch.utils.io import load_checkpoint_file, load_model

    out = {}
    frames = str(workdir / "cu_lj.xyz")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        # train (1 epoch, float32, options as JSON): every counter starts at 0
        options = {
            "seed": 0, "base_precision": 32, "device": "auto",
            "architecture": {"name": "pet", "training": {
                "batch_size": 2, "num_epochs": 1, "loss": TRAIN_LOSS}},
            "training_set": dataset_section(frames), "validation_set": 0.25, "test_set": 0.0,
        }
        Path("options.json").write_text(json.dumps(options))
        _lib.LAUNCHES.clear()
        t0 = time.perf_counter()
        with CapturedLog("metatrain_tpu_torch.train") as messages:
            cli(["train", "options.json"])
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        launches = dict(_lib.LAUNCHES)
        expected = [K1_F32, *K2DW_F32, *K4DW_F32, *K3_F32]
        missing = [k for k in expected if launches.get(k, 0) == 0]
        if missing or launches.get("fused_layer_fwd", 0):
            fail(f"kernels not launched by the train command: {missing}, or the general K1 "
                 f"launched: {launches.get('fused_layer_fwd', 0)}")
        check_k2dw_launches(launches)
        check_k4dw_launches(launches)
        out["train_launches"] = launches
        final = {split: logged_metrics(messages, split + " ") for split in ("train", "validation")}
        values = [v for metrics in final.values() for v in metrics.values()]
        if not all(final.values()) or not all(math.isfinite(v) for v in values):
            fail(f"the train command's final evaluation logged {final}")
        out["final_evaluation"] = final

        # export: model.ckpt's weights (its best ones) bit for bit in the file
        ckpt = Path(glob.glob("outputs/*/*/model.ckpt")[0])
        out["train_dir"] = str(ckpt.parent.resolve())
        with open(ckpt.parent / "train.csv") as f:
            out["train_epoch_s"] = float(next(csv.DictReader(f))["epoch time (s)"])
        cli(["export", str(ckpt), "-o", "exported.mtt"])
        raw = load_checkpoint_file(ckpt)
        best = raw["params"] if raw["best_params"] is None else raw["best_params"]
        for name in ("exported.mtt", "model.mtt"):
            flat = dict(flatten(load_checkpoint_file(name)["checkpoint"]["params"]))
            ref = dict(flatten(best))
            if flat.keys() != ref.keys() or not all(
                    flat[k].dtype == ref[k].dtype and np.array_equal(flat[k], ref[k]) for k in ref):
                fail(f"{name}: its weights are not model.ckpt's best weights bit for bit")

        # eval model.mtt (f32 kernels) against the same eval on the plain path
        Path("eval.json").write_text(json.dumps(dataset_section(frames)))
        _lib.LAUNCHES.clear()
        with CapturedLog("metatrain_tpu_torch.eval") as messages:
            cli(["eval", "model.mtt", "eval.json", "-o", "preds.xyz"])
        torch.cuda.synchronize()
        out["eval_launches"] = dict(_lib.LAUNCHES)
        if not out["eval_launches"].get(K1_F32) or out["eval_launches"].get("fused_layer_fwd", 0):
            fail(f"eval launched {out['eval_launches']}: the Hopper float32 K1 and no general K1 "
                 "expected")
        kernel = logged_metrics([m for m in messages if not m.startswith("Evaluation time")])
        plain = eval_model("model.mtt", dataset_section(frames), device=device, plain=True)
        worst = max(abs(kernel[k] - plain[k]) / abs(plain[k]) for k in plain)
        if kernel.keys() != plain.keys() or not worst <= 1e-4:
            fail(f"eval: kernel path {kernel} vs plain path {plain}")
        if not Path("preds.xyz").exists():
            fail("eval wrote no preds.xyz")
        out["eval"] = {"kernel": kernel, "plain": plain, "worst_rel": worst}
        torch.cuda.empty_cache()

        # Calculator("model.mtt") on the crystal: f32 kernel vs f32 plain path
        crystal = bench_crystal()
        n = len(crystal)
        calc = Calculator("model.mtt")
        plain_calc = Calculator(load_model("model.mtt", device=device, plain=True))
        _lib.LAUNCHES.clear()
        res = calc.compute(crystal, forces=True, stress=True)
        torch.cuda.synchronize()
        mtt_launches = dict(_lib.LAUNCHES)
        if (mtt_launches.get(K1_F32) != 4 or mtt_launches.get("fused_layer_fwd", 0)
                or mtt_launches.get("fused_layer_bwd_f32_sm90") != 4):
            fail(f"Calculator(model.mtt) launched {mtt_launches}: 4 Hopper float32 K1 and K2 and "
                 "no general K1 expected")
        ref = plain_calc.compute(crystal, forces=True, stress=True)
        e32, f32 = rel_errors(res, ref)
        if not (e32 <= 1e-5 and f32 <= 1e-4):
            fail(f"Calculator(model.mtt), f32 kernel path vs f32 plain: energy {e32:.3g}, "
                 f"forces {f32:.3g}")
        out["mtt_f32"] = {"energy_rel": e32, "force_rel_rmse": f32, "launches": mtt_launches}
        del plain_calc
        torch.cuda.empty_cache()

        # the MD weights: the run restarted (--restart auto) to 30 epochs at
        # a learning rate of 1e-3; one epoch leaves the network's forces
        # at ~100 eV/A, under which the crystal does not stay a crystal
        t0 = time.perf_counter()
        cli(["train", "options.json", "--restart", "auto",
             "-r", f"architecture.training.num_epochs={MD_EPOCHS}",
             "-r", "architecture.training.learning_rate=0.001"])
        torch.cuda.synchronize()
        out["restart_s"] = time.perf_counter() - t0
        ckpt = Path(max(glob.glob("outputs/*/*/model.ckpt"), key=os.path.getmtime))
        if load_checkpoint_file(ckpt)["epoch"] != MD_EPOCHS:
            fail(f"the restarted run did not reach epoch {MD_EPOCHS}")

        # run_md_nve, bf16 at the trained weights: the Hopper K1 and K2
        # four times per force call, the general ones never
        model16 = pet_from_checkpoint(ckpt, compute_dtype=torch.bfloat16, device=device)
        md = Calculator(model16)
        masses = np.full(n, 63.546)
        md.run_md_nve(crystal, masses, FS, 10, check_interval=10)  # warm-up
        torch.cuda.synchronize()
        updates, slots = {"n": 0}, []
        update, force_call = md._vnl.update, md._force_call

        def counted(system):
            updates["n"] += 1
            return update(system)

        def recorded(batch, forces, stress):
            slots.append(batch.max_neighbors)
            return force_call(batch, forces, stress)

        md._vnl.update, md._force_call = counted, recorded
        _lib.LAUNCHES.clear()
        t0 = time.perf_counter()
        md.run_md_nve(crystal, masses, FS, 100, check_interval=10)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        md_launches = dict(_lib.LAUNCHES)
        calls = len(slots)  # the first step's forces, then one force call per step
        if (calls != 101 or md_launches.get("fused_layer_fwd", 0)
                or md_launches.get("fused_layer_bwd", 0)
                or md_launches.get("fused_layer_fwd_sm90") != 4 * calls
                or md_launches.get("fused_layer_bwd_sm90") != 4 * calls):
            fail(f"run_md_nve launched {md_launches} in {calls} force calls at M = "
                 f"{sorted(set(slots))}: 4 Hopper K1 and 4 Hopper K2 per call expected, the "
                 "general K1 and K2 never")
        out["md"] = {"steps": 100, "seconds": seconds, "ms_per_step": seconds / 100 * 1e3,
                     "atom_steps_per_s": n * 100 / seconds, "rebuilds": updates["n"] - 1,
                     "launches": md_launches, "atoms": n, "max_neighbors": sorted(set(slots))}
        md._vnl.update, md._force_call = update, force_call
        out["compute_bf16"] = time_force_calls({"kernel_bf16": md}, crystal)["kernel_bf16"]

        # the first 10 steps against the f32 plain path's: within 1e-3 A, or,
        # where the plain path in bf16 is itself further off (the model's own
        # bf16 rounding), within 1.25 x its distance (phase 3's rule)
        rms = lambda x: float(np.sqrt(np.mean(x**2)))  # noqa: E731
        short = md.run_md_nve(crystal, masses, FS, 10, check_interval=10)
        paths = {}
        for key, dtype in (("plain_f32", torch.float32), ("plain_bf16", torch.bfloat16)):
            plain_md = Calculator(load_model(ckpt, device=device, plain=True,
                                             compute_dtype=dtype))
            paths[key] = plain_md.run_md_nve(crystal, masses, FS, 10, check_interval=10)
            if key == "plain_f32":
                out["md_forces_rms_eV_per_A"] = rms(plain_md.compute(crystal)["forces"])
            del plain_md
            torch.cuda.empty_cache()
        ref = paths["plain_f32"].positions
        drift = float(np.abs(short.positions - ref).max())
        drift_plain = float(np.abs(paths["plain_bf16"].positions - ref).max())
        out["md_vs_f32_plain"] = {
            "max_abs_A": drift, "rms_A": rms(short.positions - ref),
            "plain_bf16_max_abs_A": drift_plain,
            "plain_bf16_rms_A": rms(paths["plain_bf16"].positions - ref),
            "moved_max_A": float(np.abs(ref - crystal.positions).max()),
            "moved_rms_A": rms(ref - crystal.positions)}
        if not drift <= max(1e-3, 1.25 * drift_plain):
            fail(f"run_md_nve bf16 kernels vs f32 plain: positions {drift:.3g} A apart "
                 f"after 10 steps ({out['md_vs_f32_plain']})")

        # one forced list rebuild and one batch build on the crystal
        rebuild, build = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            nbr = compute_neighbor_data(crystal, md.cutoff + md.skin)
            rebuild.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch_from_systems([crystal], [nbr], device, n_atoms_padded=bucket_atoms(n, 1.1),
                               n_systems_padded=2,
                               max_neighbors=bucket_neighbors(nbr.max_neighbors, 1.1))
            torch.cuda.synchronize()
            build.append((time.perf_counter() - t0) * 1e3)
        out["host"] = {"list_rebuild_ms": rebuild, "batch_build_ms": build}
    finally:
        os.chdir(cwd)
    report["entry_points"] = out


def disk_copies(workdir):
    """Phase 5's frames as 7b's ``train`` reads them (the extended xyz's
    float64 values), written to ``frames.zip`` and ``frames.memmap/``."""
    from metatrain_tpu_torch.data.disk import DiskDatasetWriter, write_memmap_dataset
    from metatrain_tpu_torch.data.readers.extxyz import read_xyz

    frames = read_xyz(str(workdir / "cu_lj.xyz"))
    energies = [float(f.extra["energy"]) for f in frames]
    forces = [np.asarray(f.extra["forces"], dtype=np.float64) for f in frames]
    with DiskDatasetWriter(str(workdir / "frames.zip")) as writer:
        for frame, energy, force in zip(frames, energies, forces):
            writer.write(frame, {"energy": {"values": np.asarray([energy]),
                                            "positions_gradient": -force}})
    write_memmap_dataset(str(workdir / "frames.memmap"), frames, np.asarray(energies), forces)
    return frames, energies, forces


def train_from_disk(cli, workdir, read_from, first):
    """``train`` (7b's options, ``read_from`` the disk copy) in a directory
    of its own: its launches, its final evaluation, its epoch time and
    whether its final weights equal 7b's extxyz run's bit for bit."""
    import csv
    import glob
    import os

    from metatrain_tpu_torch.ops.kernels import _lib
    from metatrain_tpu_torch.utils.io import load_checkpoint_file

    run_dir = workdir / f"run_{Path(read_from).suffix.lstrip('.')}"
    run_dir.mkdir()
    os.chdir(run_dir)
    options = json.loads((workdir / "options.json").read_text())
    options["training_set"]["systems"]["read_from"] = str(read_from)
    Path("options.json").write_text(json.dumps(options))
    _lib.LAUNCHES.clear()
    t0 = time.perf_counter()
    with CapturedLog("metatrain_tpu_torch.train") as messages:
        cli(["train", "options.json"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    expected = [K1_F32, *K2DW_F32, *K4DW_F32, *K3_F32]
    missing = [k for k in expected if launches.get(k, 0) == 0]
    if missing or launches.get("fused_layer_fwd", 0):
        fail(f"train from {read_from}: kernels not launched: {missing}, or the general K1 "
             f"launched: {launches.get('fused_layer_fwd', 0)}")
    check_k2dw_launches(launches)
    check_k4dw_launches(launches)
    final = {split: logged_metrics(messages, split + " ") for split in ("train", "validation")}
    ref = first["final_evaluation"]
    if any(final[s].keys() != ref[s].keys() for s in ref):
        fail(f"train from {read_from}: final evaluation {final}, the extxyz run's {ref}")
    worst = max(abs(final[s][k] - ref[s][k]) / abs(ref[s][k]) for s in ref for k in ref[s])
    if not worst <= 1e-6:
        fail(f"train from {read_from}: final evaluation {final}, the extxyz run's "
             f"{first['final_evaluation']} (worst relative difference {worst})")
    ckpt = Path(glob.glob("outputs/*/*/model.ckpt")[0])
    with open(ckpt.parent / "train.csv") as f:
        epoch_s = float(next(csv.DictReader(f))["epoch time (s)"])
    ours = dict(flatten(load_checkpoint_file(ckpt)["params"]))
    theirs = dict(flatten(load_checkpoint_file(Path(first["train_dir"]) / "model.ckpt")["params"]))
    equal = ours.keys() == theirs.keys() and all(np.array_equal(ours[k], theirs[k])
                                                 for k in theirs)
    return {"seconds": seconds, "epoch_s": epoch_s, "launches": launches,
            "launches_equal_extxyz": launches == first["train_launches"],
            "final_evaluation": final, "worst_rel_vs_extxyz": worst,
            "weights_equal_extxyz": equal}


def check_writers(cli, workdir, device):
    """``eval model.mtt`` written to ``.xyz``, ``.zip``, ``.mts`` and a
    memmap directory, each read back; then ``eval`` with the energy target
    read from an ``.mts`` file against the extended xyz's."""
    from metatrain_tpu_torch.cli.eval import eval_model
    from metatrain_tpu_torch.containers import Labels, TensorBlock, TensorMap
    from metatrain_tpu_torch.data.disk import DiskDataset, MemmapDataset
    from metatrain_tpu_torch.data.readers.extxyz import read_xyz
    from metatrain_tpu_torch.data.readers.mts import load_mts, save_mts

    out = {}
    t0 = time.perf_counter()
    for name in ("preds.xyz", "preds.zip", "preds.mts", "preds/"):
        cli(["eval", "model.mtt", "eval.json", "-o", name])
    torch.cuda.synchronize()
    out["eval_s"] = time.perf_counter() - t0
    frames = read_xyz("preds.xyz")
    offsets = np.cumsum([0] + [len(f) for f in frames])
    xyz_e = np.array([float(f.extra["energy"]) for f in frames])
    xyz_f = np.concatenate([f.extra["energy_forces"] for f in frames])
    block = load_mts("preds_energy.mts").block(0)
    read = {"mts": (np.asarray(block.values)[:, 0],
                    -np.asarray(block.gradient("positions").values)[:, :, 0])}
    for key, dataset in (("zip", DiskDataset("preds.zip")), ("memmap", MemmapDataset("preds"))):
        blocks = [dataset[i].targets["energy"].block(0) for i in range(len(dataset))]
        read[key] = (np.array([float(np.asarray(b.values)[0, 0]) for b in blocks]),
                     np.concatenate([-np.asarray(b.gradient("positions").values)[:, :, 0]
                                     for b in blocks]))
        positions = np.concatenate([dataset[i].system.positions for i in range(len(dataset))])
        if len(dataset) != len(frames) or np.abs(
                positions - np.concatenate([f.positions for f in frames])).max() > 5.1e-11:
            fail(f"eval -o {key}: its systems are not preds.xyz's")
    for key, (energies, forces) in read.items():
        # the xyz holds the energies as repr(float), the forces as "%.10f"
        if not (np.array_equal(energies, xyz_e) and forces.shape == xyz_f.shape
                and np.abs(forces - xyz_f).max() <= 5.1e-11):
            fail(f"eval -o {key}: energies or forces read back differ from preds.xyz's")
        if not (np.array_equal(forces, read["mts"][1]) and np.array_equal(energies,
                                                                          read["mts"][0])):
            fail(f"eval -o {key}: its float64 values differ from the .mts file's")
    out["read_back"] = {"systems": len(frames), "atoms": int(offsets[-1]),
                        "energies_equal_xyz": True, "float64_formats_equal": True,
                        "max_abs_force_vs_xyz": float(np.abs(read["mts"][1] - xyz_f).max())}

    # the energy target from an .mts file (save_mts of the frames' labels)
    labelled = read_xyz("cu_lj.xyz")
    props = Labels(["energy"], np.zeros((1, 1), np.int32))
    energy = TensorBlock(np.array([[float(f.extra["energy"])] for f in labelled]),
                         Labels(["system"], np.arange(len(labelled)).reshape(-1, 1)), [], props)
    samples = np.array([[s, s, a] for s, f in enumerate(labelled) for a in range(len(f))])
    energy.add_gradient("positions", TensorBlock(
        -np.concatenate([f.extra["forces"] for f in labelled]).reshape(-1, 3, 1),
        Labels(["sample", "system", "atom"], samples),
        [Labels(["xyz"], np.arange(3).reshape(-1, 1))], props))
    save_mts(TensorMap(Labels.single(), [energy]), "energy.mts")
    section = dataset_section("cu_lj.xyz")
    via_xyz = eval_model("model.mtt", section, device=device)
    section["targets"] = {"energy": {"read_from": "energy.mts", "unit": "eV"}}
    via_mts = eval_model("model.mtt", section, device=device)
    worst = max(abs(via_mts[k] - via_xyz[k]) / abs(via_xyz[k]) for k in via_xyz)
    if via_mts.keys() != via_xyz.keys() or not worst <= 1e-6:
        fail(f"eval with an .mts energy target: {via_mts}, with the extended xyz's: {via_xyz}")
    out["mts_target"] = {"metrics": via_mts, "metrics_xyz": via_xyz, "worst_rel": worst}
    return out


def jittered(crystal, n, seed):
    """``n`` copies of the crystal's positions, each with a fresh 0.01 A jitter."""
    rng = np.random.default_rng(seed)
    return [crystal.positions + rng.normal(0, 0.01, crystal.positions.shape) for _ in range(n)]


def check_serve(cli, workdir, crystal, direct):
    """``serve model.mtt`` in a thread, a ``ForceClient`` sending the crystal
    2 + 10 times; the answers against ``direct`` on the same positions."""
    import threading

    from metatrain_tpu_torch.containers import System
    from metatrain_tpu_torch.ops.kernels import _lib
    from metatrain_tpu_torch.serve import ForceClient

    sock = str(workdir / "serve.sock")
    ended = {}

    def serve():
        try:
            ended["rc"] = cli(["serve", "model.mtt", "--unix", sock])
        except Exception as err:  # noqa: BLE001 - the phase fails on it below
            ended["error"] = repr(err)

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    client = None
    for _ in range(1200):
        try:
            client = ForceClient(unix=sock)
            break
        except (FileNotFoundError, ConnectionRefusedError):
            if not thread.is_alive():
                fail(f"serve ended before it listened: {ended}")
            time.sleep(0.1)
    if client is None:
        fail("serve did not listen within 120 s")
    positions = jittered(crystal, 12, seed=31)
    types, cell, pbc = crystal.types, crystal.cell, crystal.pbc
    answers, ms = [], []
    for i, pos in enumerate(positions):
        if i == 2:  # after the warm-up: every counter starts at 0
            torch.cuda.synchronize()
            _lib.LAUNCHES.clear()
        t0 = time.perf_counter()
        answers.append(client.compute(pos, types, cell, pbc))
        if i >= 2:
            ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_lib.LAUNCHES)
    client.close()
    thread.join(timeout=120)
    if thread.is_alive() or ended.get("rc") != 0:
        fail(f"serve did not end with 0 after its client left: {ended}")
    per_request = {k: v / 10 for k, v in launches.items()}
    if (per_request.get(K1_F32) != 4 or per_request.get("fused_layer_bwd_f32_sm90") != 4
            or launches.get("fused_layer_fwd", 0) or launches.get("fused_layer_bwd", 0)):
        fail(f"serve launched {launches} in 10 requests: the Hopper float32 K1 and K2 4 times "
             "each a request, the general K1 and K2 never expected")
    check_rowblock_f32_call("serve", per_request)

    # the direct calculator on the same positions in the same order
    worst = {"energy": 0.0, "forces": 0.0, "virial": 0.0}
    bitwise, direct_ms = True, []
    volume = abs(np.linalg.det(cell))
    for i, (pos, answer) in enumerate(zip(positions, answers)):
        t0 = time.perf_counter()
        ref = direct.compute(System(pos, types, cell, pbc), forces=True, stress=True)
        if i >= 2:
            direct_ms.append((time.perf_counter() - t0) * 1e3)
        virial = -ref["stress"] * volume
        worst["energy"] = max(worst["energy"], abs(answer["energy"] - ref["energy"])
                              / abs(ref["energy"]))
        worst["forces"] = max(worst["forces"], float(np.abs(answer["forces"] - ref["forces"]).max()
                                                     / np.abs(ref["forces"]).max()))
        worst["virial"] = max(worst["virial"], float(np.abs(answer["virial"] - virial).max()
                                                     / np.abs(virial).max()))
        bitwise &= (answer["energy"] == ref["energy"] and np.array_equal(answer["forces"],
                                                                         ref["forces"])
                    and np.array_equal(answer["virial"], virial))
    if not all(v <= 1e-6 for v in worst.values()):
        fail(f"serve's answers vs Calculator.compute: worst relative differences {worst}")
    return {"atoms": len(crystal), "requests": 10, "warm_up": 2, "ms_per_request": ms,
            "mean_ms_per_request": float(np.mean(ms)), "compute_ms_per_call": direct_ms,
            "mean_compute_ms": float(np.mean(direct_ms)),
            "protocol_ms": float(np.mean(ms) - np.mean(direct_ms)), "launches": launches,
            "worst_rel": worst, "bitwise_equal_compute": bool(bitwise)}


IPI_HDR = 12


def ipi_server(sock, crystal, positions_list, results):
    """A minimal i-PI server: INIT, then POSDATA + GETFORCE per position
    set, then EXIT; each round's answer in atomic units and its ms."""
    from metatrain_tpu_torch.ipi import BOHR

    def send(conn, msg):
        conn.sendall(msg.ljust(IPI_HDR).encode())

    def recv(conn, n):
        data = b""
        while len(data) < n:
            chunk = conn.recv(n - len(data))
            if not chunk:
                raise ConnectionError("the i-PI driver closed the connection")
            data += chunk
        return data

    def expect(conn, word):
        got = recv(conn, IPI_HDR).strip()
        if got != word:
            raise RuntimeError(f"i-PI driver answered {got!r}, expected {word!r}")

    conn, _ = sock.accept()
    try:
        send(conn, "STATUS")
        expect(conn, b"NEEDINIT")
        send(conn, "INIT")
        conn.sendall(np.int32(0).tobytes() + np.int32(0).tobytes())
        for positions in positions_list:
            send(conn, "STATUS")
            expect(conn, b"READY")
            t0 = time.perf_counter()
            send(conn, "POSDATA")
            conn.sendall((crystal.cell / BOHR).T.astype(np.float64).tobytes()
                         + np.zeros((3, 3)).tobytes() + np.int32(len(crystal)).tobytes()
                         + (positions / BOHR).astype(np.float64).tobytes())
            send(conn, "STATUS")
            expect(conn, b"HAVEDATA")
            send(conn, "GETFORCE")
            expect(conn, b"FORCEREADY")
            energy = np.frombuffer(recv(conn, 8), np.float64)[0]
            natoms = int(np.frombuffer(recv(conn, 4), np.int32)[0])
            forces = np.frombuffer(recv(conn, 24 * natoms), np.float64).reshape(natoms, 3)
            virial = np.frombuffer(recv(conn, 72), np.float64).reshape(3, 3)
            if np.frombuffer(recv(conn, 4), np.int32)[0] != 0:
                raise RuntimeError("the i-PI driver sent an extra string")
            results.append({"energy": energy, "forces": forces.copy(), "virial": virial.copy(),
                            "ms": (time.perf_counter() - t0) * 1e3})
        send(conn, "EXIT")
    except Exception as err:  # noqa: BLE001 - the caller fails on it
        results.append({"error": repr(err)})
    finally:
        conn.close()


def pairs_within(system, nbr, cutoff):
    """The sorted ``(center, neighbor, shift)`` rows of a NEF list whose
    distance on ``system``'s positions is below ``cutoff``."""
    centers, slots = np.nonzero(nbr.mask)
    neighbors = nbr.indices[centers, slots]
    shifts = nbr.shifts[centers, slots]
    d = system.positions[neighbors] - system.positions[centers] + shifts @ system.cell
    keep = np.linalg.norm(d, axis=1) < cutoff
    rows = np.column_stack([centers[keep], neighbors[keep], shifts[keep]]).astype(np.int64)
    return rows[np.lexsort(rows.T[::-1])]


def max_force_rel(forces, ref):
    return float(np.abs(forces - ref).max() / np.abs(ref).max())


def check_drive(cli, workdir, crystal, device):
    """``drive model.mtt crystal.xyz`` against the i-PI server above, 5
    rounds, the answers in eV and A against direct ``compute`` calls on the
    positions and cell as the wire gave them (through bohr):

    - ``same_lists``: a new ``Calculator("model.mtt")`` given the rounds in
      the driver's order, so with the driver's neighbor lists (built on the
      first round at cutoff + skin and reused): forces within 1e-5 of max
      |F| and energies within 1e-5 relative; what the wire adds.
    - ``fresh_lists``: a calculator whose list is built on each round's own
      positions. Its pairs within the cutoff are the driver's (checked
      exactly); only the skin shell's pairs, whose cutoff factor is 0,
      and the slot order differ, so the float32 sums run in another order.
      Two witnesses tell that order from a difference in what is summed:
      the same comparison in float64 on the plain path, on the 2,048-atom
      crystal (within 1e-9 of max |F|: a pair that counted would show
      there as in float32), and the
      round with its atoms relabelled in a random order on fresh lists
      (forces put back), whose distance from ``fresh_lists`` is the
      float32 order noise at this size. ``fresh_lists`` must stay within
      1e-4 of max |F|, the float32 tolerance phase 7b holds the kernel path
      to against the plain one on this crystal, and within 4 times that
      noise."""
    import socket
    import threading

    from metatrain_tpu_torch.calculator import Calculator
    from metatrain_tpu_torch.containers import System
    from metatrain_tpu_torch.data.readers.extxyz import write_xyz
    from metatrain_tpu_torch.ipi import BOHR, HARTREE
    from metatrain_tpu_torch.ops.neighbors import compute_neighbor_data
    from metatrain_tpu_torch.utils.io import load_model

    write_xyz(str(workdir / "crystal.xyz"), [crystal])
    path = str(workdir / "ipi.sock")
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.bind(path)
    sock.listen(1)
    positions = jittered(crystal, 5, seed=32)
    results = []
    thread = threading.Thread(target=ipi_server, args=(sock, crystal, positions, results),
                              daemon=True)
    thread.start()
    try:
        rc = cli(["drive", "model.mtt", "crystal.xyz", "--unix", path])
    finally:
        thread.join(timeout=120)
        sock.close()
    errors = [r["error"] for r in results if "error" in r]
    if rc != 0 or errors or len(results) != 5 or thread.is_alive():
        fail(f"drive: rc {rc}, {len(results)} rounds, errors {errors}")

    # the positions and cell as the i-PI driver has them, through bohr
    cell = (crystal.cell / BOHR) * BOHR
    seen = [System((pos / BOHR) * BOHR, crystal.types, cell, crystal.pbc) for pos in positions]
    answers = [r["forces"] * (HARTREE / BOHR) for r in results]
    model = load_model("model.mtt", device=device)
    same = Calculator(model)
    cutoff, skin = same.cutoff, same.skin
    worst = {"same_lists": 0.0, "fresh_lists": 0.0, "relabelled": 0.0}
    rng = np.random.default_rng(33)
    built, pairs_equal = seen[0], True
    for k, (answer, result, system) in enumerate(zip(answers, results, seen)):
        ref = same.compute(system, forces=True, stress=True)
        worst["same_lists"] = max(worst["same_lists"], max_force_rel(answer, ref["forces"]))
        if not abs(result["energy"] * HARTREE - ref["energy"]) <= 1e-5 * abs(ref["energy"]):
            fail(f"drive: energy {result['energy'] * HARTREE} eV, compute's {ref['energy']}")
        # the driver's list: the rule of VerletNeighborList.update
        if np.linalg.norm(system.positions - built.positions, axis=1).max() >= skin / 2:
            built = system
        if k == 0:
            continue  # the round the driver's list was built on
        pairs_equal &= np.array_equal(
            pairs_within(system, compute_neighbor_data(built, cutoff + skin), cutoff),
            pairs_within(system, compute_neighbor_data(system, cutoff + skin), cutoff))
        fresh = Calculator(model).compute(system, forces=True)["forces"]
        worst["fresh_lists"] = max(worst["fresh_lists"], max_force_rel(answer, fresh))
        order = rng.permutation(len(system))
        moved = Calculator(model).compute(
            System(system.positions[order], system.types[order], cell, crystal.pbc),
            forces=True)["forces"]
        back = np.empty_like(moved)
        back[order] = moved
        worst["relabelled"] = max(worst["relabelled"], max_force_rel(back, fresh))
    del same, model
    torch.cuda.empty_cache()
    if not worst["same_lists"] <= 1e-5:
        fail(f"drive: forces {worst['same_lists']:.3g} of max |F| from Calculator.compute's "
             "on the same lists")
    if not pairs_equal:
        fail("drive: the driver's reused list and a fresh one hold other pairs within the cutoff")

    # float64 on the plain path (whose activations at 10,976 atoms would
    # not fit beside the rest): the 2,048-atom crystal, its lists built on
    # a first jitter and reused on a second vs built on the second
    small = bench_crystal(8)
    first, second = (System(pos, small.types, small.cell, small.pbc)
                     for pos in jittered(small, 2, seed=34))
    model64 = load_model("model.mtt", device=device, plain=True, compute_dtype=torch.float64)
    history = Calculator(model64, dtype=torch.float64)
    history.compute(first, forces=True)
    f64_history = history.compute(second, forces=True)["forces"]
    f64_fresh = Calculator(model64, dtype=torch.float64).compute(second, forces=True)["forces"]
    worst["float64_fresh_lists"] = max_force_rel(f64_history, f64_fresh)
    f64_pairs_equal = np.array_equal(
        pairs_within(second, compute_neighbor_data(first, cutoff + skin), cutoff),
        pairs_within(second, compute_neighbor_data(second, cutoff + skin), cutoff))
    del history, model64
    torch.cuda.empty_cache()
    if not f64_pairs_equal:
        fail("drive: the 2,048-atom crystal's reused list lost a pair within the cutoff")
    if not worst["float64_fresh_lists"] <= 1e-9:
        fail(f"drive: in float64 the driver's lists and fresh ones give forces "
             f"{worst['float64_fresh_lists']:.3g} of max |F| apart: they sum other pairs")
    if not (worst["fresh_lists"] <= 1e-4 and worst["fresh_lists"] <= 4 * worst["relabelled"]):
        fail(f"drive: forces {worst['fresh_lists']:.3g} of max |F| from compute on fresh lists, "
             f"the float32 order noise (atoms relabelled) {worst['relabelled']:.3g}")
    ms = [r["ms"] for r in results]
    return {"rounds": 5, "ms_per_round": ms, "mean_ms_per_round": float(np.mean(ms)),
            "worst_force_rel": worst, "pairs_within_cutoff_equal": bool(pairs_equal),
            "driver_list_rebuilt": built is not seen[0]}


def check_disk_and_servers(device, report, workdir):
    """Phase 7c: training from the ``.zip`` and memmap copies of phase 5's
    frames, the ``.zip`` / ``.mts`` / memmap prediction writers and the
    ``.mts`` target reader, ``serve`` and ``drive``; in 7b's directory, on
    its ``model.mtt``."""
    import os

    from metatrain_tpu_torch.__main__ import main as cli
    from metatrain_tpu_torch.calculator import Calculator

    first = report["entry_points"]
    out = report["disk_and_servers"] = {}
    cwd = os.getcwd()
    t_phase = time.perf_counter()
    try:
        disk_copies(workdir)
        for key, read_from in (("zip", workdir / "frames.zip"),
                               ("memmap", workdir / "frames.memmap")):
            out[f"train_{key}"] = train_from_disk(cli, workdir, read_from, first)
            torch.cuda.empty_cache()
        out["train_epoch_s"] = {"extxyz": first["train_epoch_s"],
                                "zip": out["train_zip"]["epoch_s"],
                                "memmap": out["train_memmap"]["epoch_s"]}
        os.chdir(workdir)
        out["writers"] = check_writers(cli, workdir, device)
        torch.cuda.empty_cache()
        crystal = bench_crystal()
        direct = Calculator("model.mtt")
        out["serve"] = check_serve(cli, workdir, crystal, direct)
        del direct
        torch.cuda.empty_cache()
        out["drive"] = check_drive(cli, workdir, crystal, device)
    finally:
        os.chdir(cwd)
    out["seconds"] = time.perf_counter() - t_phase


def flatten(tree, prefix=""):
    """``(path, array)`` pairs of a nested dict of arrays."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from flatten(value, f"{prefix}/{key}")
    else:
        yield prefix, np.asarray(tree)


SOURCES = {
    "fused_layer_fwd": ("metatrain_tpu_torch/csrc/fused_layer_fwd.cu",
                        "metatrain_tpu/ops/pallas/fused_layer.py:1161"),
    "fused_layer_fwd_sm90": ("metatrain_tpu_torch/csrc/fused_layer_fwd_sm90.cu",
                             "metatrain_tpu/ops/pallas/fused_layer.py:1161 (exact bf16)"),
    "fused_layer_fwd_f32_sm90": ("metatrain_tpu_torch/csrc/fused_layer_fwd_f32_sm90.cu",
                                 "metatrain_tpu/ops/pallas/fused_layer.py:1161 (float32)"),
    "fused_layer_bwd": ("metatrain_tpu_torch/csrc/fused_layer_bwd_sm90.cu",
                        "metatrain_tpu/ops/pallas/fused_layer.py:1269 (exact bf16; f32: "
                        "csrc/fused_layer_bwd.cu)"),
    "rowblock_fwd": ("metatrain_tpu_torch/csrc/rowblock_fwd.cu",
                     "metatrain_tpu/ops/pallas/rowblock.py:113"),
    "rowblock_fwd_sm90": ("metatrain_tpu_torch/csrc/rowblock_fwd_sm90.cu",
                          "metatrain_tpu/ops/pallas/rowblock.py:113 (exact bf16, d_part 128)"),
    "rowblock_fwd_f32_sm90": ("metatrain_tpu_torch/csrc/rowblock_fwd_f32_sm90.cu",
                              "metatrain_tpu/ops/pallas/rowblock.py:113 (float32, d_part 128)"),
    "rowblock_bwd": ("metatrain_tpu_torch/csrc/rowblock_bwd.cu",
                     "metatrain_tpu/ops/pallas/rowblock.py:279"),
    "rowblock_bwd_sm90": ("metatrain_tpu_torch/csrc/rowblock_bwd_sm90.cu",
                          "metatrain_tpu/ops/pallas/rowblock.py:279 (exact bf16, d_part 128)"),
    "fused_layer_bwd_f32_sm90": ("metatrain_tpu_torch/csrc/fused_layer_bwd_f32_sm90.cu",
                                 "metatrain_tpu/ops/pallas/fused_layer.py:1269 (float32)"),
    "fused_layer_bwd_dw": ("metatrain_tpu_torch/csrc/fused_layer_bwd_dw_sm90.cu",
                           "metatrain_tpu/ops/pallas/fused_layer.py:1269 (weight_grads=True)"),
    "rowblock_bwd_dw": ("metatrain_tpu_torch/csrc/rowblock_bwd.cu",
                        "metatrain_tpu/ops/pallas/rowblock.py:279 (weight_grads=True)"),
    "rowblock_bwd_f32_sm90": ("metatrain_tpu_torch/csrc/rowblock_bwd_f32_sm90.cu",
                              "metatrain_tpu/ops/pallas/rowblock.py:279 (float32, d_part 128)"),
    "rowblock_bwd_dw_f32_sm90": ("metatrain_tpu_torch/csrc/rowblock_bwd_f32_sm90.cu",
                                 "metatrain_tpu/ops/pallas/rowblock.py:279 "
                                 "(weight_grads=True, float32, d_part 128)"),
    "permute": ("metatrain_tpu_torch/csrc/permute.cu",
                "metatrain_tpu/ops/pallas/color_gather.py:834 and :635"),
    "permute_acc": ("metatrain_tpu_torch/csrc/permute.cu",
                    "metatrain_tpu/ops/pallas/color_gather.py:834 and :635 (acc)"),
    "window_attention_fwd": ("metatrain_tpu_torch/csrc/window_attention_fwd.cu",
                             "metatrain_tpu/ops/pallas/attention.py:412"),
    "window_attention_bwd": ("metatrain_tpu_torch/csrc/window_attention_bwd.cu",
                             "metatrain_tpu/ops/pallas/attention.py:500"),
    "gnn_block_fwd": ("metatrain_tpu_torch/csrc/gnn_block_fwd.cu",
                      "metatrain_tpu/ops/pallas/fused_layer.py:1759"),
    "gnn_block_bwd": ("metatrain_tpu_torch/csrc/gnn_block_bwd.cu",
                      "metatrain_tpu/ops/pallas/fused_layer.py:1805"),
    "gnn_block_bwd_dw": ("metatrain_tpu_torch/csrc/gnn_block_bwd.cu",
                         "metatrain_tpu/ops/pallas/fused_layer.py:1805 (weight_grads=True)"),
    "gnn_block_fwd_sm90": ("metatrain_tpu_torch/ops/kernels/gnn_block.py (block_forward: "
                           "csrc/fused_layer_fwd_sm90.cu, csrc/gnn_node_sm90.cu)",
                           "metatrain_tpu/ops/pallas/fused_layer.py:1759 (exact bf16)"),
    "gnn_block_bwd_sm90": ("metatrain_tpu_torch/ops/kernels/gnn_block.py (block_backward: "
                           "csrc/fused_layer_{fwd,bwd}_sm90.cu, csrc/gnn_node_sm90.cu)",
                           "metatrain_tpu/ops/pallas/fused_layer.py:1805 (exact bf16)"),
    "gnn_node_fwd_sm90": ("metatrain_tpu_torch/csrc/gnn_node_sm90.cu",
                          "metatrain_tpu/ops/pallas/fused_layer.py:1759 (the node stream, bf16)"),
    "gnn_node_bwd_sm90": ("metatrain_tpu_torch/csrc/gnn_node_sm90.cu",
                          "metatrain_tpu/ops/pallas/fused_layer.py:1805 (the node stream, bf16)"),
    "gnn_block_fwd_f32_sm90": ("metatrain_tpu_torch/ops/kernels/gnn_block.py (block_forward: "
                               "csrc/fused_layer_fwd_f32_sm90.cu, csrc/gnn_node_f32_sm90.cu)",
                               "metatrain_tpu/ops/pallas/fused_layer.py:1759 (float32)"),
    "gnn_block_bwd_f32_sm90": ("metatrain_tpu_torch/ops/kernels/gnn_block.py (block_backward: "
                               "csrc/fused_layer_{fwd,bwd}_f32_sm90.cu, csrc/gnn_node_f32_sm90.cu)",
                               "metatrain_tpu/ops/pallas/fused_layer.py:1805 (float32)"),
    "gnn_block_bwd_dw_f32_sm90": ("metatrain_tpu_torch/ops/kernels/gnn_block.py (block_backward: "
                                  "csrc/fused_layer_fwd_f32_sm90.cu, "
                                  "csrc/fused_layer_bwd_dw_sm90.cu, csrc/gnn_node_f32_sm90.cu)",
                                  "metatrain_tpu/ops/pallas/fused_layer.py:1805 "
                                  "(weight_grads=True, float32)"),
    "gnn_node_fwd_f32_sm90": ("metatrain_tpu_torch/csrc/gnn_node_f32_sm90.cu",
                              "metatrain_tpu/ops/pallas/fused_layer.py:1759 "
                              "(the node stream, float32)"),
    "gnn_node_bwd_f32_sm90": ("metatrain_tpu_torch/csrc/gnn_node_f32_sm90.cu",
                              "metatrain_tpu/ops/pallas/fused_layer.py:1805 "
                              "(the node stream, float32)"),
    "gnn_node_bwd_dw_f32_sm90": ("metatrain_tpu_torch/csrc/gnn_node_f32_sm90.cu",
                                 "metatrain_tpu/ops/pallas/fused_layer.py:1805 "
                                 "(the node stream, weight_grads=True, float32)"),
    "fused_layer_fwd_w8a8_sm90": ("metatrain_tpu_torch/csrc/fused_layer_fwd_sm90.cu",
                                  "metatrain_tpu/ops/pallas/fused_layer.py:1161 (calib, W8A8)"),
    "fused_layer_bwd_w8a8_sm90": ("metatrain_tpu_torch/csrc/fused_layer_bwd_sm90.cu",
                                  "metatrain_tpu/ops/pallas/fused_layer.py:1269 (calib, W8A8)"),
    "int8_absmax": ("metatrain_tpu_torch/csrc/int8_absmax.cu",
                    "metatrain_tpu/ops/pallas/fused_layer.py:163 (_quantize_i8, per block)"),
    "int8_absmax_sm90": ("metatrain_tpu_torch/csrc/int8_absmax_sm90.cu",
                         "metatrain_tpu/ops/pallas/fused_layer.py:163 "
                         "(_quantize_i8, per block; the Hopper K1-int8's q and k)"),
    "fused_layer_fwd_int8": ("metatrain_tpu_torch/csrc/fused_layer_fwd.cu",
                             "metatrain_tpu/ops/pallas/fused_layer.py:1161 (int8 scores)"),
    "fused_layer_fwd_int8_sm90": ("metatrain_tpu_torch/csrc/fused_layer_fwd_sm90.cu",
                                  "metatrain_tpu/ops/pallas/fused_layer.py:1161 "
                                  "(int8 scores, bf16)"),
    "fused_layer_bwd_int8_sm90": ("metatrain_tpu_torch/csrc/fused_layer_bwd_sm90.cu",
                                  "metatrain_tpu/ops/pallas/fused_layer.py:1269 "
                                  "(int8 scores, bf16)"),
    "fused_layer_bwd_dw_int8": ("metatrain_tpu_torch/csrc/fused_layer_bwd_dw_sm90.cu",
                                "metatrain_tpu/ops/pallas/fused_layer.py:1269 "
                                "(weight_grads=True, int8 scores)"),
}
UNFUSED_PATH = ("permute", "permute_acc", "window_attention_fwd", "window_attention_bwd")
N_ENTRIES = 55


def launch_count(report, name):
    """Launches of ``name`` in the run of its path: the block's bf16 force
    calls for the Hopper block's node-stream kernels (and, for the Hopper
    block's entries, its calls: a sequence of launches), its f32 call for
    the float32 ones (its f32 training step for the weight-gradient
    backward and the spill mode), its f32 call at M = 96 for the general
    block's forward and backward, its exact bf16 training step for the
    general block's weight-gradient kernel, the training run for the
    other weight-gradient kernels, the exact bf16 training step for K1's
    general body (the served bf16 calls run the Hopper K1, the float32
    calls and steps at the served shapes the Hopper float32 K1), the d_pet
    256 force calls for the general K3
    and K4 (the served d_pet 128 calls run the Hopper K3 and K4 for every
    stage), the unfused force calls for the kernels
    that path added, the W8A8 force calls for the Hopper W8A8 pair (the
    general W8A8 bodies run on no path: its entries' general_ms), the fused
    force calls for the rest; the int8 scores' from their force calls and
    (K2-dW-int8, the general K1-int8, the general absmax pass) their
    training step. K2-dW and K2-dW-int8 count the
    two-pass kernels' launches (K2-dW in the float32 training run: the
    Hopper float32 K2's spill mode); the Hopper float32 K1, K2, K3 and K4
    their launches in one call of phase 3's float32 kernel path; the general
    K4-dW's compress and combination theirs in the exact bf16 step (the
    float32 steps run the two-pass K4-dW)."""
    if name == "fused_layer_bwd_dw_int8":
        return report["training_parity_int8"]["launches"]["fused_layer_bwd_dw_int8_sm90"]
    if name in ("fused_layer_fwd_int8", "int8_absmax"):
        # the served int8 calls run the Hopper K1-int8 and the Hopper pass
        return report["training_parity_int8"]["launches"][name]
    if name == "fused_layer_bwd_dw":
        return report["train_launches"][K2DW_F32[0]]
    if name in (K1_F32, "fused_layer_bwd_f32_sm90") or name.startswith(
            ("rowblock_bwd_f32_sm90", "rowblock_fwd_f32_sm90")):
        return report["slice"]["launches_f32_per_call"][name]
    if name == "fused_layer_fwd":  # float32 runs the Hopper float32 K1 at these shapes
        return report["training_parity_bf16"]["launches"][name]
    if name in K4DW_GENERAL:
        # float32 steps run the two-pass K4-dW, bf16 steps this body
        return report["training_parity_bf16"]["launches"][name]
    if name.endswith("_int8") or name in ("int8_absmax_sm90", *INT8_SM90):
        source = report["slice_int8"]["launches"]
    elif name in W8A8_SM90:
        source = report["slice_w8a8"]["launches"]
    elif name in ("gnn_block_fwd", "gnn_block_bwd"):  # the served calls run the Hopper block
        return report["slice_gnn_m96"]["launches_f32_per_call"][name]
    elif name == "gnn_block_bwd_dw":  # the f32 step runs the Hopper block
        return report["training_parity_gnn_bf16"]["launches"][name]
    elif name == "gnn_block_bwd_dw_f32_sm90":  # sequences, not kernels
        return report["training_parity_gnn"]["calls"][name]
    elif name.startswith("gnn_block") and name.endswith("_f32_sm90"):
        return report["slice_gnn"]["calls_f32_per_call"][name]
    elif name.startswith("gnn_block") and name.endswith("_sm90"):
        return report["slice_gnn"]["calls"][name]
    elif name == "gnn_node_bwd_dw_f32_sm90":
        return report["training_parity_gnn"]["launches"][name]
    elif name.startswith("gnn_node") and name.endswith("_f32_sm90"):
        return report["slice_gnn"]["launches_f32_per_call"][name]
    elif name.startswith(("gnn_block", "gnn_node")):
        source = report["slice_gnn"]["launches"]
    elif "_dw" in name:
        source = report["train_launches"]
    elif name in ROWBLOCK_KERNELS:
        source = report["slice_d256"]["launches"]
    else:
        source = report["unfused" if name in UNFUSED_PATH else "slice"]["launches"]
    if name == "fused_layer_bwd":  # the served bf16 calls run the Hopper K2
        return source["fused_layer_bwd_sm90"]
    return source[name]


def kernel_entries(report, kernels):
    """The ``kernels`` line's entries, one per kernel of ``kernels``."""
    # the served paths run in bfloat16 and the training path in float32:
    # each entry leads with the errors and times of its path's dtype, and
    # its launches are those of its path's run (the unfused force calls for
    # the kernels that path added)
    entries = []
    for name, entry in kernels.items():
        source, replaces = SOURCES[name.split("[")[0]]
        # the float32 kernels lead with float32 (the Hopper float32 K1 and K2
        # have no bf16 numbers)
        trains = ("_dw" in name and "ms_f32" in entry
                  or "ms_bf16" not in entry and "ms_f32" in entry
                  or name in ("gnn_block_fwd", "gnn_block_bwd"))
        if name == "gnn_block_bwd_dw":  # launched by the exact bf16 G step
            trains = False
        lead, other = ("f32", "bf16") if trains else ("bf16", "f32")
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launch_count(report, name),
               "dtype": "float32" if trains else "bfloat16"}
        for tag, suffix in ((lead, ""), (other, f"_{other}")):
            if f"ms_{tag}" not in entry:  # the W8A8 kernels run in bfloat16 only
                continue
            out[f"max_abs_err{suffix}"] = entry[f"max_abs_err_{tag}"]
            out[f"ms{suffix}"] = entry[f"ms_{tag}"]
            out[f"plain_ms{suffix}"] = entry[f"plain_ms_{tag}"]
            out[f"bound_ms{suffix}"] = entry[f"bound_ms_{tag}"]
            out[f"bound_by{suffix}"] = entry[f"bound_by_{tag}"]
            out[f"library_ms{suffix}"] = entry.get(f"library_ms_{tag}", entry.get("library_ms"))
            if f"per_layer_ms_{tag}" in entry:
                out[f"per_layer_ms{suffix}"] = entry[f"per_layer_ms_{tag}"]
            if f"general_ms_{tag}" in entry:  # the Hopper kernels' general bodies
                out[f"general_ms{suffix}"] = entry[f"general_ms_{tag}"]
            if f"workspace_bytes_{tag}" in entry:  # the two-pass K2-dW's spill
                out[f"workspace_bytes{suffix}"] = entry[f"workspace_bytes_{tag}"]
            if f"bound_ms_ffma_{tag}" in entry:  # the Hopper float32 K1 and K2 on FFMA pipes
                out[f"bound_ms_ffma{suffix}"] = entry[f"bound_ms_ffma_{tag}"]
        if name.startswith("fused_layer_bwd_dw"):  # the two-pass K2-dW's second kernel
            out["product_launches"] = (
                report["training_parity_int8"]["launches"] if name.endswith("_int8")
                else report["train_launches"])["layer_dw_product"]
        if name.startswith("rowblock_bwd_dw_f32_sm90"):  # the two-pass K4-dW's second pass
            out["product_launches"] = report["train_launches"]["rowblock_dw_product"]
        if name == "gnn_node_bwd_dw_f32_sm90":  # the node weights' second pass
            out["product_launches"] = report["training_parity_gnn"]["launches"][
                "gnn_node_dw_product"]
            out["product_ms"] = entry["product_ms_f32"]
        if "shapes" in entry:
            out["shapes"] = entry["shapes"]
        entries.append(out)
    return entries


def load_tool(name):
    """``metatrain_tpu_torch/tools/<name>.py`` of this checkout as a module."""
    path = Path(__file__).resolve().parent / "metatrain_tpu_torch" / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"chip_smoke_{name}", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def check_head_front(front, libs, report, rows=100003):
    """The Hopper float32 head's shared forward: ``tools/sm90_front.py``'s
    copies of the f32 K3 head and the f32 K4 head (``libs``, built beside the
    kernels) must compute pre0, h0 and pre1 to the same bits on every row of
    ``rows`` (the last tile partial); the K3 head's output is silu(pre1), so
    it equals the K4 head's recompute."""
    res = front.rowblock_compare("head", rows, libs)
    if not (all(res["bitwise_equal"].values()) and res["every_row_written"]):
        fail(f"the f32 K3 head's forward differs from the f32 K4 head's recompute: {res}")
    for name in ("rowblock_fwd_f32_sm90[head]", "rowblock_bwd_f32_sm90[head]"):
        report[name]["front_equal_k4" if "fwd" in name else "front_equal_k3"] = res


def check_absmax_front(front, libs, report, seeds=(0, 1, 2)):
    """The Hopper absmax pass's scales against the per-block max of the
    Hopper K1-int8's own q and k, bit for bit: ``tools/sm90_front.py``'s
    K1-int8 copy (``libs["k1_int8"]``, built beside the kernels) dumps the
    q|k it quantizes. At an odd A = 2,047 (the last pair holds one atom,
    the last scale block is partial) and M = 64, 48, 16 in the served
    blocks (8 and 128 atoms), and at the served A = 11,392, M = 64; each
    also in blocks of 2 atoms (one atom pair: a maximum over 8 to 128 atoms
    hides a value one ulp off, one over a pair rarely does), there on
    ``seeds``. Reported beside, not gated: how many blocks of the general
    pass (q and k of the general bodies, another summation order) differ
    from that max, per run and in all (``general_pair_blocks_differ``)."""
    from metatrain_tpu_torch.ops.kernels import fused_layer as fl

    def hopper(e, c, w, H, block_atoms):
        return fl.int8_absmax_sm90_cuda(e, c, fl.LayerWeights(*w), H, block_atoms)

    def general(e, c, w, block_atoms):
        return fl.int8_absmax_cuda(e, c, fl.LayerWeights(*w), block_atoms)

    shapes, pair_blocks, pair_differ = {}, 0, 0
    for A, M in ((2047, 64), (2047, 48), (2047, 16), (11392, 64)):
        for BA in (fl.int8_block_atoms(M), 2):
            for seed in seeds if BA == 2 else seeds[:1]:
                res = front.absmax_compare(libs["k1_int8"], A, M, hopper, seed=seed,
                                           general_blocks=general, block_atoms=BA)
                if not (res["bitwise_equal"] and res["qk_finite"]):
                    fail(f"the Hopper absmax pass's scales are not the Hopper K1-int8's q|k max: "
                         f"{res}")
                shapes[f"A{A}_M{M}_blocks{BA}_seed{seed}"] = res
                if BA == 2:
                    pair_blocks += res["blocks"]
                    pair_differ += res["general_blocks_differ"]
                torch.cuda.empty_cache()
    report["int8_absmax_sm90"]["equal_k1_int8_qk"] = shapes
    report["int8_absmax_sm90"]["general_pair_blocks_differ"] = {
        "differ": pair_differ, "blocks": pair_blocks}


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
    from metatrain_tpu_torch._build import BUILD_DIR
    from metatrain_tpu_torch.interop.jax_params import pet_from_checkpoint
    from metatrain_tpu_torch.models.pet import DEFAULT_MODEL_HYPERS
    from metatrain_tpu_torch.ops import neighbors
    from metatrain_tpu_torch.ops.kernels import _lib

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # the f32 heads' shared forward, and the Hopper absmax pass against the
    # Hopper K1-int8's own q and k, are checked on copies instrumented by
    # tools/sm90_front.py: their nvcc runs beside the kernels' build
    front = load_tool("sm90_front")
    front_dir = tempfile.TemporaryDirectory()
    front_procs = front.spawn(Path(front_dir.name),
                              front.ROWBLOCK_KERNELS["head"] + (front.K1_INT8,))
    t0 = time.perf_counter()
    try:
        _lib.library()
        build_s = time.perf_counter() - t0
    finally:
        front_libs = front.load(Path(front_dir.name), front_procs)
    print(f"build: {build_s:.1f} s (the head copies {time.perf_counter() - t0:.1f} s)", flush=True)
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    # the compiler's registers and spills per kernel (nvcc -Xptxas -v)
    build_log = BUILD_DIR / f"{_lib.LIBRARY}.log"
    if build_log.exists():
        (out_dir / "chip_smoke_build.log").write_text(build_log.read_text())

    report = {"card": card, "build_s": build_s}
    neighbors.BACKENDS.clear()
    report["slice"] = check_slice(device, {}, FUSED_SM90_KERNELS)
    check_neighbor_backend(report)
    check_hopper_launches("slice", report["slice"])
    f32_call = report["slice"]["launches_f32_per_call"]
    if (f32_call.get("fused_layer_bwd_f32_sm90") != 4 or f32_call.get("fused_layer_bwd", 0)
            or f32_call.get(K1_F32) != 4 or f32_call.get("fused_layer_fwd", 0)):
        fail(f"the f32 force call launched {f32_call}: 4 Hopper float32 K1 and K2 and no general "
             "K1 or K2 expected")
    check_rowblock_f32_call("slice", f32_call)
    A, M = report["slice"]["padded"]
    print("slice:", json.dumps({k: report["slice"][k] for k in (
        "padded", "launches", "launches_f32_per_call", "parity")}
        | {"neighbor_backends": report["neighbor_backends"]}), flush=True)
    print(f"force call ({card}):", json.dumps(report["slice"]["timing"]), flush=True)
    print("force call profile:", json.dumps(report["slice"]["profile_kernel_bf16"]), flush=True)
    torch.cuda.empty_cache()

    # PET's physics options on the served call, beside phase 3's
    with tempfile.TemporaryDirectory() as tmp:
        check_physics(device, report, Path(tmp))
    for key in PHYSICS:
        print(f"{key}:", json.dumps({k: report[key][k] for k in (
            "hypers", "padded", "launches", "parity", "acted")}), flush=True)
        print(f"{key} force call ({card}), phase 3 beside:", json.dumps({
            "timing": report[key]["timing"], "option_times": report[key]["option_times"],
            "phase_3": report["slice"]["timing"]}), flush=True)
        print(f"{key} training step, f32 kernel vs plain:",
              json.dumps(report[f"training_parity_{key}"]), flush=True)
    print("physics_b force call profile:", json.dumps(report["physics_b"]["profile_kernel_bf16"]),
          flush=True)
    print("physics_b cutoff_stats, bf16 kernel vs f32 plain:",
          json.dumps(report["physics_b"]["cutoff_stats"]), flush=True)

    # generic targets: every output of phase 3c's PET in one served call
    with tempfile.TemporaryDirectory() as tmp:
        check_generic(device, report, Path(tmp))
    generic = report["generic"]
    print("generic targets:", json.dumps({k: generic[k] for k in (
        "padded", "launches_per_call", "errors", "member_gradients_worst_rel")}), flush=True)
    print(f"generic targets call ({card}), phase 3 beside:", json.dumps({
        "timing": generic["timing"], "phase_3": report["slice"]["timing"]}), flush=True)
    print("generic targets training step, f32 kernel vs plain:",
          json.dumps(generic["training_parity"]), flush=True)
    print("generic targets eval round trip:", json.dumps(generic["eval_round_trip"]), flush=True)
    torch.cuda.empty_cache()

    # each GNN layer as one block: in bf16 the Hopper block (the Hopper K1
    # and K2 and the node-stream kernels, the general block never), in f32
    # the general block's kernels, two launches each per force call
    report["slice_gnn"] = check_slice(device, {}, GNN_KERNELS, fused_gnn=True)
    gnn = report["slice_gnn"]
    per_call, f32_call = gnn["launches_per_call"], gnn["launches_f32_per_call"]
    general = ("fused_layer_fwd", "fused_layer_bwd") + GNN_GENERAL
    if any(k in gnn["launches"] for k in general) or any(
            per_call.get(k) != v for k, v in GNN_SM90_PER_CALL.items()) or gnn["calls"] != {
            "gnn_block_fwd_sm90": 6, "gnn_block_bwd_sm90": 6}:
        fail(f"the block's bf16 force calls launched {gnn['launches']} in {gnn['calls']}")
    if any(f32_call.get(k) != v for k, v in GNN_F32_PER_CALL.items()) or any(
            k in f32_call for k in general + tuple(GNN_SM90_PER_CALL)) or gnn[
            "calls_f32_per_call"] != {"gnn_block_fwd_f32_sm90": 2, "gnn_block_bwd_f32_sm90": 2}:
        fail(f"the block's f32 force call launched {f32_call} in {gnn['calls_f32_per_call']}")
    check_rowblock_launches("slice_gnn", gnn, ROWBLOCK_SM90_PER_CALL)
    print("GNN block slice:", json.dumps({k: gnn[k] for k in (
        "padded", "launches", "launches_f32_per_call", "parity")}), flush=True)
    print(f"GNN block force call ({card}):", json.dumps(gnn["timing"]), flush=True)
    print("GNN block force call profile:", json.dumps(gnn["profile_kernel_bf16"]), flush=True)
    torch.cuda.empty_cache()

    # outside the Hopper shapes the general block pair serves both dtypes:
    # the block at a 5.5 A cutoff (M = 96)
    # (8^3 cells, 2,048 atoms: the plain paths' block at M = 96 outgrows the
    # card on the crystal)
    report["slice_gnn_m96"] = check_slice(device, M96, GNN_M96_KERNELS, n_cells=8, steps=2,
                                          timing=False, fused_gnn=True)
    m96 = report["slice_gnn_m96"]
    hopper = tuple(GNN_SM90_PER_CALL) + tuple(GNN_F32_PER_CALL)
    for key, calls in (("bf16", m96["launches_per_call"]), ("f32", m96["launches_f32_per_call"])):
        if (calls.get("gnn_block_fwd") != 2 or calls.get("gnn_block_bwd") != 2
                or any(k in calls for k in hopper)):
            fail(f"the block's {key} force call at M = 96 launched {calls}: the general pair "
                 "2 + 2 and no Hopper block expected")
    if m96["padded"][1] < 80:
        fail(f"the 5.5 A cutoff served M = {m96['padded'][1]}, expected at least 80")
    print("GNN block at M = 96:", json.dumps({k: m96[k] for k in (
        "padded", "launches_per_call", "launches_f32_per_call", "parity")}), flush=True)
    torch.cuda.empty_cache()

    for key, hypers, kwargs in (("unfused", UNFUSED, {}),
                                ("unfused_alt", UNFUSED_ALT, {"steps": 2, "timing": False})):
        report[key] = check_slice(device, hypers, UNFUSED_KERNELS, **kwargs)
        check_rowblock_launches(key, report[key], ROWBLOCK_SM90_PER_CALL if key == "unfused"
                                else ROWBLOCK_RESIDUAL_PER_CALL)
        print(f"{key} slice:", json.dumps({k: report[key][k] for k in ("padded", "launches",
                                                                        "parity")}), flush=True)
        torch.cuda.empty_cache()
    print(f"unfused force call ({card}):", json.dumps(report["unfused"]["timing"]), flush=True)
    print("unfused force call profile:", json.dumps(report["unfused"]["profile_kernel_bf16"]),
          flush=True)
    A_u, M_u = report["unfused"]["padded"]

    # the static W8A8 layers: the Hopper K1-W8A8 and K2-W8A8 replace K1 and
    # K2, four launches each per force call
    state = random_state({})
    report["slice_w8a8"] = check_w8a8_slice(
        device, lambda dtype, plain, int8: make_pet(dtype, plain, state, device, int8_static=int8))
    w8 = report["slice_w8a8"]
    check_rowblock_launches("slice_w8a8", w8, ROWBLOCK_SM90_PER_CALL)
    print("W8A8 slice:", json.dumps({k: w8[k] for k in ("padded", "launches", "parity")}),
          flush=True)
    print(f"W8A8 force call ({card}):", json.dumps(w8["timing"]), flush=True)
    print("W8A8 force call profile:", json.dumps(w8["profile_w8a8_kernel_bf16"]), flush=True)
    torch.cuda.empty_cache()

    # windows above 64 slots: a 5.5 A cutoff on the crystal (78 neighbours
    # within 6.0 A); then d_pet 256 (8 heads of 32); kernel paths timed
    for key, hypers, rowblocks, per_call in (
            ("slice_m96", M96, ROWBLOCK_SM90_KERNELS, ROWBLOCK_SM90_PER_CALL),
            ("slice_d256", D256, ROWBLOCK_KERNELS, ROWBLOCK_D256_PER_CALL)):
        report[key] = check_slice(device, hypers, FUSED_KERNELS + rowblocks, steps=2,
                                  time_plain=False)
        check_rowblock_launches(key, report[key], per_call)
        M_served = report[key]["padded"][1]
        if key == "slice_m96" and M_served < 80:
            fail(f"the 5.5 A cutoff served M = {M_served}, expected at least 80")
        # the Hopper float32 K1 does not take these shapes: the general K1
        f32_call = report[key]["launches_f32_per_call"]
        if f32_call.get("fused_layer_fwd") != 4 or f32_call.get(K1_F32, 0):
            fail(f"{key}: the f32 force call launched {f32_call}: 4 general K1 and no Hopper "
                 "float32 K1 expected")
        # the row blocks do not depend on M: at M = 96 the Hopper float32 K3,
        # at d_pet 256 the general K3
        check_rowblock_f32_call(key, f32_call, general=key == "slice_d256")
        print(f"{key} (M = {M_served}):", json.dumps({k: report[key][k] for k in (
            "padded", "launches", "parity")}), flush=True)
        print(f"{key} force call ({card}):", json.dumps(report[key]["timing"]), flush=True)
        torch.cuda.empty_cache()

    # the dynamic int8 scores: the Hopper absmax pass, K1-int8 and K2-int8
    # replace K1 and K2, four launches each per force call
    report["slice_int8"] = check_int8_slice(device, state)
    i8 = report["slice_int8"]
    check_rowblock_launches("slice_int8", i8, ROWBLOCK_SM90_PER_CALL)
    print("int8 slice:", json.dumps({k: i8[k] for k in ("padded", "launches", "parity")}),
          flush=True)
    print(f"int8 force call ({card}):", json.dumps(i8["timing"]), flush=True)
    print("int8 force call profile:", json.dumps(i8["profile_int8_kernel_bf16"]), flush=True)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        trained = check_training(device, report, workdir)
        state = {k: v.detach().clone() for k, v in trained.module.state_dict().items()}
        del trained
        print("training:", json.dumps({k: report[k] for k in ("train_launches", "train_replays")}
                                      | {"seconds": report["training"]["seconds"]}), flush=True)
        # W8A8 at the trained weights: model.ckpt served as a user would
        # (composition and scaler included), calibrated on the crystal
        ckpt = workdir / "model.ckpt"
        report["w8a8_trained"] = check_w8a8_slice(
            device, lambda dtype, plain, int8: pet_from_checkpoint(
                ckpt, compute_dtype=dtype, device=device, plain=plain, int8_static=int8),
            steps=1, timing=False)
        check_rowblock_launches("w8a8_trained", report["w8a8_trained"], ROWBLOCK_SM90_PER_CALL)
        print("W8A8 at the trained weights:", json.dumps(report["w8a8_trained"]["parity"]),
              flush=True)
        torch.cuda.empty_cache()
        report["training_parity"] = check_training_parity(
            workdir / "cu_lj.xyz", state, device, expected=(K1_F32,) + K2DW_F32 + K4DW_F32 + K3_F32,
            absent=("fused_layer_fwd",) + K2DW_F32_NEVER + K4_F32_NEVER + K3_F32_NEVER,
            per_step={K1_F32: K1_F32_PER_STEP} | {k: K2DW_PER_STEP for k in K2DW_F32}
            | K4DW_F32_PER_STEP | K3_F32_PER_STEP)
        print("training parity:", json.dumps(report["training_parity"]), flush=True)
        report["training_parity_unfused"] = check_training_parity(
            workdir / "cu_lj.xyz", random_state(UNFUSED), device, UNFUSED,
            expected=("window_attention_fwd", "window_attention_bwd", "permute", "permute_acc"),
            replayed=("window_attention",))
        print("training parity, unfused:", json.dumps(report["training_parity_unfused"]),
              flush=True)
        # the f32 G step: the Hopper float32 block, its weight gradients from
        # K2-dW and the node stream's spill mode and products
        report["training_parity_gnn"] = check_training_parity(
            workdir / "cu_lj.xyz", state, device, expected=tuple(GNN_F32_PER_STEP),
            replayed=("gnn_block",), fused_gnn=True,
            absent=GNN_GENERAL + tuple(GNN_SM90_PER_CALL) + ("fused_layer_fwd",
                                                            "gnn_node_bwd_f32_sm90")
            + K2DW_F32_NEVER, per_step=GNN_F32_PER_STEP)
        if report["training_parity_gnn"]["calls"] != {"gnn_block_fwd_f32_sm90": 2,
                                                      "gnn_block_bwd_dw_f32_sm90": 4}:
            fail(f"the f32 G step's block calls: {report['training_parity_gnn']['calls']}")
        print("training parity, GNN block:", json.dumps(report["training_parity_gnn"]),
              flush=True)
        # the exact bf16 G step keeps the general block (the Hopper K1 rounds
        # P, the weight-gradient backward and the replay do not)
        report["training_parity_gnn_bf16"] = check_training_parity(
            workdir / "cu_lj.xyz", state, device, expected=("gnn_block_fwd", "gnn_block_bwd_dw"),
            replayed=("gnn_block",), fused_gnn=True, dtype=torch.bfloat16,
            absent=tuple(GNN_SM90_PER_CALL) + tuple(GNN_F32_PER_STEP))
        print("training step, exact bf16 GNN block:",
              json.dumps(report["training_parity_gnn_bf16"]), flush=True)
        # weights require grad: the general K1-int8, whose P is float like
        # K2-dW-int8's first pass and the replay's, and the general absmax
        # pass, whose q and k are its; never the Hopper pair or pass
        report["training_parity_int8"] = check_training_parity(
            workdir / "cu_lj.xyz", state, device,
            expected=("int8_absmax", "fused_layer_fwd_int8", *K2DW_INT8),
            replayed=("fused_layer",), int8_scores=True,
            absent=("fused_layer_bwd_dw_int8", "fused_layer_bwd_int8", "int8_absmax_sm90",
                    *INT8_SM90),
            per_step={"int8_absmax": 4, "fused_layer_fwd_int8": 4}
            | {k: K2DW_PER_STEP for k in K2DW_INT8})
        print("training step, int8 scores (bf16):", json.dumps(report["training_parity_int8"]),
              flush=True)
        # the exact bf16 step: a weight requires grad, so the general K1
        # (P float, as K2-dW and the replay keep it) and never the Hopper
        # kernels, K4-dW for the row blocks
        report["training_parity_bf16"] = check_training_parity(
            workdir / "cu_lj.xyz", state, device,
            expected=("fused_layer_fwd", *K2DW, *K4DW_GENERAL),
            replayed=("fused_layer",), dtype=torch.bfloat16,
            absent=("fused_layer_fwd_sm90", K1_F32, "fused_layer_bwd_sm90", "fused_layer_bwd_dw",
                    *ROWBLOCK_SM90_KERNELS, *K4_F32, *K4DW_F32, *K3_F32),
            per_step={k: K2DW_PER_STEP for k in K2DW})
        print("training step, exact bf16:", json.dumps(report["training_parity_bf16"]), flush=True)
        torch.cuda.empty_cache()
        time_training(workdir, state, device, report)
        print(f"training step ({card}):", json.dumps(report["training_timing"]), flush=True)
        torch.cuda.empty_cache()
        check_entry_points(device, report, workdir)
        print(f"entry points ({card}):", json.dumps(report["entry_points"]), flush=True)
        torch.cuda.empty_cache()
        check_disk_and_servers(device, report, workdir)
        print(f"disk data, writers and servers ({card}):",
              json.dumps(report["disk_and_servers"]), flush=True)

    hp = DEFAULT_MODEL_HYPERS
    D, H, F = hp["d_pet"], hp["num_heads"], hp["d_feedforward"]
    gen = torch.Generator().manual_seed(0)
    kernels: dict = {}
    check_fused_layer(A, M, D, H, F, gen, device, kernels)
    check_sm90_shapes(gen, device, kernels, D, H, F)
    if build_log.exists():
        for name, kernel in (("fused_layer_fwd_sm90", "k1_sm90_kernelILi0E"),
                             ("fused_layer_bwd", "k2_sm90_kernelILi0E")):
            kernels[name]["ptxas_bf16"] = ptxas_usage(build_log.read_text(), kernel)
        # the plain and the spill-mode instantiation
        kernels["fused_layer_bwd_f32_sm90"]["ptxas_f32"] = ptxas_usage(
            build_log.read_text(), "k2_f32_sm90_kernel")
        kernels[K1_F32]["ptxas_f32"] = ptxas_usage(build_log.read_text(), "k1_f32_sm90_kernel")
    kernels["fused_layer_bwd_f32_sm90"]["smem_bytes"] = _lib.library(
    ).mtt_fused_layer_bwd_f32_sm90_smem(M, D, H, F)
    kernels[K1_F32]["smem_bytes"] = _lib.library().mtt_fused_layer_fwd_f32_sm90_smem(M, D, H, F)
    for title, name, tag in (("Hopper K1", "fused_layer_fwd_sm90", "bf16"),
                             ("Hopper K2", "fused_layer_bwd", "bf16"),
                             ("Hopper float32 K1", K1_F32, "f32"),
                             ("Hopper float32 K2", "fused_layer_bwd_f32_sm90", "f32")):
        print(f"{title} (general body's ms beside):", json.dumps(
            {k: kernels[name].get(k) for k in (
                f"ms_{tag}", f"general_ms_{tag}", f"bound_ratio_{tag}", f"bound_ms_{tag}",
                "bound_ms_ffma_f32", f"ptxas_{tag}", "smem_bytes", "shapes")
             if k in kernels[name]}), flush=True)
    check_gnn_block(A, M, D, H, F, hp["d_node"], gen, device, kernels,
                    hp["num_attention_layers"])
    if build_log.exists():
        # the float32 backward's instantiations hold the spill mode's too
        for name, kernel, tag in (("gnn_node_fwd_sm90", "node_fwd_kernel", "bf16"),
                                  ("gnn_node_bwd_sm90", "node_bwd_kernel", "bf16"),
                                  ("gnn_node_fwd_f32_sm90", "node_fwd_f32_kernel", "f32"),
                                  ("gnn_node_bwd_f32_sm90", "node_bwd_f32_kernel", "f32"),
                                  ("gnn_node_bwd_dw_f32_sm90", "node_bwd_f32_kernel", "f32")):
            kernels[name][f"ptxas_{tag}"] = ptxas_usage(build_log.read_text(), kernel)
    lib = _lib.library()
    for name in ("gnn_node_fwd_sm90", "gnn_node_bwd_sm90"):
        kernels[name]["smem_bytes"] = lib.mtt_gnn_node_sm90_smem(hp["d_node"], D,
                                                                 int("bwd" in name))
    for name in ("gnn_node_fwd_f32_sm90", "gnn_node_bwd_f32_sm90", "gnn_node_bwd_dw_f32_sm90"):
        kernels[name]["smem_bytes"] = lib.mtt_gnn_node_f32_sm90_smem(hp["d_node"], D,
                                                                     int("bwd" in name))
    check_gnn_sm90_shapes(D, H, F, gen, device, kernels)
    for title, name, tag in (
            ("Hopper GNN block forward", "gnn_block_fwd_sm90", "bf16"),
            ("Hopper GNN block backward", "gnn_block_bwd_sm90", "bf16"),
            ("Hopper node-stream forward", "gnn_node_fwd_sm90", "bf16"),
            ("Hopper node-stream backward", "gnn_node_bwd_sm90", "bf16"),
            ("Hopper float32 GNN block forward", "gnn_block_fwd_f32_sm90", "f32"),
            ("Hopper float32 GNN block backward", "gnn_block_bwd_f32_sm90", "f32"),
            ("Hopper float32 GNN block weight-gradient backward", "gnn_block_bwd_dw_f32_sm90",
             "f32"),
            ("Hopper float32 node-stream forward", "gnn_node_fwd_f32_sm90", "f32"),
            ("Hopper float32 node-stream backward", "gnn_node_bwd_f32_sm90", "f32"),
            ("Hopper float32 node-stream spill mode", "gnn_node_bwd_dw_f32_sm90", "f32")):
        print(f"{title} ({card}; the general block's ms beside):", json.dumps(
            {k: kernels[name].get(k) for k in (
                f"ms_{tag}", f"plain_ms_{tag}", f"per_layer_ms_{tag}", f"general_ms_{tag}",
                f"bound_ms_{tag}", "bound_ms_ffma_f32", f"bound_ratio_{tag}",
                "recompute_equal_forward", f"product_ms_{tag}", f"ptxas_{tag}", "smem_bytes",
                "shapes") if k in kernels[name]}
            | {f"general_ms_{tag}": kernels.get(general_name(name), {}).get(f"ms_{tag}")}),
            flush=True)
    report["gnn_block_variants"] = check_gnn_block_variants(M, D, H, F, hp["d_node"], gen, device)
    print("GNN block variants (max abs error, bound ratio):",
          json.dumps(report["gnn_block_variants"]), flush=True)
    check_rowblock(A * M, D, gen, device, kernels)
    check_rowblock_sm90_shapes(gen, device, kernels, D)
    check_head_front(front, front_libs, kernels)
    lib = _lib.library()
    for code, stage in enumerate(STAGE_NAMES):
        w_in, w_hid = {"compress": (3 * D, D), "combination": (2 * D, 2 * D), "head": (D, D)}[stage]
        for name in (f"rowblock_bwd_f32_sm90[{stage}]", f"rowblock_bwd_dw_f32_sm90[{stage}]"):
            kernels[name]["smem_bytes"] = lib.mtt_rowblock_bwd_f32_sm90_smem(code, D, w_in, w_hid, D)
            if build_log.exists():  # the plain and spill-mode instantiations (mangled names)
                kernels[name]["ptxas_f32"] = ptxas_usage(build_log.read_text(),
                                                         f"k4_f32_sm90_kernelILi{code}E")
            print(f"Hopper float32 {name} (general body's ms beside):", json.dumps(
                {key: kernels[name].get(key) for key in (
                    "ms_f32", "general_ms_f32", "plain_ms_f32", "bound_ms_f32", "bound_ms_ffma_f32",
                    "bound_ratio_f32", "product_ms_f32", "chunks_f32", "ptxas_f32", "smem_bytes",
                    "front_equal_k3", "shapes")}), flush=True)
        name = f"rowblock_fwd_f32_sm90[{stage}]"
        kernels[name]["smem_bytes"] = lib.mtt_rowblock_fwd_f32_sm90_smem(code, D, w_in, w_hid, D)
        if build_log.exists():  # the instantiations per stage (mangled names)
            kernels[name]["ptxas_f32"] = ptxas_usage(build_log.read_text(),
                                                     f"k3_f32_sm90_kernelILi{code}E")
        print(f"Hopper float32 {name} (general body's ms beside):", json.dumps(
            {key: kernels[name].get(key) for key in (
                "ms_f32", "general_ms_f32", "plain_ms_f32", "bound_ms_f32", "bound_ms_ffma_f32",
                "bound_ratio_f32", "ptxas_f32", "smem_bytes", "front_equal_k4", "shapes")}),
            flush=True)
    for k in (3, 4):
        kind = "fwd" if k == 3 else "bwd"
        for code, stage in enumerate(STAGE_NAMES):
            name = f"rowblock_{kind}_sm90[{stage}]"
            # the shared bytes per block from the C side's query, at the
            # served widths (the 3-part compress)
            w_in, w_hid = {"compress": (3 * D, D), "combination": (2 * D, 2 * D),
                           "head": (D, D)}[stage]
            kernels[name]["smem_bytes"] = getattr(lib, f"mtt_rowblock_{kind}_sm90_smem")(
                code, D, w_in, w_hid, D)
            if build_log.exists():  # the instantiations per stage (mangled names)
                kernels[name]["ptxas_bf16"] = ptxas_usage(
                    build_log.read_text(),
                    f"k{k}_head_sm90_kernel" if stage == "head" else f"k{k}_sm90_kernelILi{code}E")
            print(f"Hopper K{k} {name} (general body's ms beside):", json.dumps(
                {key: kernels[name].get(key) for key in (
                    "ms_bf16", "general_ms_bf16", "bound_ms_bf16", "bound_ratio_bf16",
                    "equal_general_bf16", "front_equal_k3_bf16", "ptxas_bf16", "smem_bytes",
                    "shapes")}), flush=True)
    check_permute(A_u * M_u, D, gen, device, kernels)
    check_attention(A_u, M_u + 1, D, H, gen, device, kernels)
    check_w8a8_layer(A, M, D, H, F, gen, device, kernels)
    check_int8_layer(A, M, D, H, F, gen, device, kernels)
    for M_shape in (48, 16):
        check_w8a8_layer(11000, M_shape, D, H, F, gen, device, kernels, tag=f"A11000_M{M_shape}")
        check_int8_layer(11000, M_shape, D, H, F, gen, device, kernels, tag=f"A11000_M{M_shape}")
    check_absmax_front(front, front_libs, kernels)
    front_dir.cleanup()
    if build_log.exists():  # the int8-score and W8A8 instantiations (MODE 1, 2)
        for name, kernel in (("fused_layer_fwd_int8_sm90", "k1_sm90_kernelILi1E"),
                             ("fused_layer_bwd_int8_sm90", "k2_sm90_kernelILi1E"),
                             (W8A8_SM90[0], "k1_sm90_kernelILi2E"),
                             (W8A8_SM90[1], "k2_sm90_kernelILi2E"),
                             ("int8_absmax_sm90", "absmax_sm90_kernel")):
            kernels[name]["ptxas_bf16"] = ptxas_usage(build_log.read_text(), kernel)
    print(f"Hopper absmax pass ({card}; the general pass's ms beside):", json.dumps(
        {k: kernels["int8_absmax_sm90"].get(k) for k in (
            "ms_bf16", "general_ms_bf16", "plain_ms_bf16", "bound_ms_bf16", "scale_ulps_bf16",
            "general_pair_blocks_differ", "ptxas_bf16", "smem_bytes", "shapes")}), flush=True)
    for title, name in (("Hopper K1-int8", "fused_layer_fwd_int8_sm90"),
                        ("Hopper K2-int8", "fused_layer_bwd_int8_sm90"),
                        ("Hopper K1-W8A8", W8A8_SM90[0]),
                        ("Hopper K2-W8A8", W8A8_SM90[1])):
        print(f"{title} ({card}; the general body's ms beside):", json.dumps(
            {k: kernels[name].get(k) for k in (
                "ms_bf16", "general_ms_bf16", "plain_ms_bf16", "bound_ms_bf16", "bound_ratio_bf16",
                "general_bound_ratio_bf16", "int8_mode_bf16", "general_int8_mode_bf16",
                "ptxas_bf16", "smem_bytes", "shapes")}), flush=True)
    report["plans"] = plan_table()
    print("layout plans, C vs Python:", json.dumps(report["plans"]), flush=True)
    check_layer_shapes_on_card(gen, device, kernels)
    check_wide_rowblocks(256 * 64, 256, gen, device, kernels)
    check_attention_heads(256, gen, device, kernels)
    report["kernels"] = kernels
    print(f"kernel vs plain ({card}):", json.dumps(kernels), flush=True)

    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    entries = kernel_entries(report, kernels)
    if len(entries) != N_ENTRIES:
        fail(f"expected {N_ENTRIES} kernel entries, got {sorted(kernels)}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
