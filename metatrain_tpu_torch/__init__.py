"""metatrain-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

The JAX package ``metatrain_tpu`` is the reference; this package imports
neither it nor JAX. The first slice is the PET force call: energy, forces
and virial of a periodic system through ``calculator.Calculator``, with
hand-written CUDA kernels for the fused transformer layer and the
row-block stages (``ops/kernels``, sources in ``csrc/``). The user's entry
points: ``python -m metatrain_tpu_torch train|eval|export``, the exported
``.mtt`` file (``utils.io.load_model``), ``Calculator(path)`` and its
``run_md_nve``, and ``ase_calculator``.
"""

__version__ = "0.1.0"
