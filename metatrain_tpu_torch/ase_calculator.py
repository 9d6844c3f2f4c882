"""ASE calculator adapter (optional; requires the ``ase`` package).

Counterpart of ``metatrain_tpu/ase_calculator.py``: wraps
:class:`metatrain_tpu_torch.calculator.Calculator` (Verlet-skin neighbor
reuse, cached device batches) in a standard ``ase.calculators`` object,
so ASE's dynamics drivers and optimizers run against it unchanged. As
the wrapped calculator, it ships no charge or spin multiplicity: a PET
with ``system_conditioning`` serves a neutral singlet.

ASE is optional: importing this module without ``ase`` works, and
building the calculator then raises a clear error; nothing else in the
package depends on it.
"""

from __future__ import annotations

import numpy as np

try:
    from ase.calculators.calculator import Calculator as _ASECalculator
    from ase.calculators.calculator import all_changes

    _HAVE_ASE = True
except ImportError:
    _HAVE_ASE = False

    class _ASECalculator:  # type: ignore[no-redef]
        def __init__(self, *a, **k):
            raise ImportError(
                "the ASE adapter requires the 'ase' package "
                "(pip install ase); for ASE-free serving use "
                "metatrain_tpu_torch.calculator.Calculator directly"
            )

    all_changes = ()


class MetatrainTPUCalculator(_ASECalculator):
    """ASE calculator serving a trained or exported model.

    :param model: a model object, or a path to a ``.mtt`` / ``.ckpt``.
    :param skin: Verlet skin distance for neighbor-list reuse.
    :param kwargs: passed to :class:`metatrain_tpu_torch.calculator.Calculator`
        (``device="cpu"`` to run on the CPU).
    """

    implemented_properties = ["energy", "forces", "stress"]

    def __init__(self, model, skin: float = 0.5, **kwargs):
        super().__init__()
        from .calculator import Calculator

        self._calc = Calculator(model, skin=skin, **kwargs)

    def calculate(self, atoms=None, properties=("energy",), system_changes=all_changes):
        super().calculate(atoms, properties, system_changes)
        system = ase_to_system(atoms)
        want_stress = "stress" in properties and bool(system.pbc.any())
        out = self._calc.compute(system, forces=True, stress=want_stress)
        self.results = {
            "energy": float(out["energy"]),
            "forces": np.asarray(out["forces"], dtype=np.float64),
        }
        if want_stress:
            s = np.asarray(out["stress"], dtype=np.float64)
            # ASE's Voigt order: xx, yy, zz, yz, xz, xy
            self.results["stress"] = np.array([s[0, 0], s[1, 1], s[2, 2],
                                               s[1, 2], s[0, 2], s[0, 1]])


def system_to_ase(system):
    """A :class:`metatrain_tpu_torch.containers.System` as ``ase.Atoms``
    (neighbor data and extra fields are dropped)."""
    import ase

    return ase.Atoms(numbers=np.asarray(system.types), positions=np.asarray(system.positions),
                     cell=np.asarray(system.cell), pbc=list(np.asarray(system.pbc)))


def ase_to_system(atoms):
    """An ``ase.Atoms`` as a :class:`metatrain_tpu_torch.containers.System`."""
    from .containers import System

    return System(
        positions=np.asarray(atoms.get_positions(), dtype=np.float64),
        types=np.asarray(atoms.get_atomic_numbers(), dtype=np.int32),
        cell=np.asarray(atoms.get_cell()[:], dtype=np.float64),
        pbc=np.asarray(atoms.get_pbc(), dtype=bool),
    )
