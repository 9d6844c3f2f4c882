"""i-PI socket driver: serve force calls to an i-PI server.

Counterpart of ``metatrain_tpu/ipi.py``: the i-PI client-driver protocol
(also spoken by ASE's ``SocketIOCalculator``) on top of
:class:`~.calculator.Calculator`, so an exported ``.mtt`` drives an i-PI
simulation on the card::

    python -m metatrain_tpu_torch drive model.mtt template.xyz --unix ipi_run

Protocol: 12-byte ASCII headers; the server sends ``STATUS`` / ``INIT`` /
``POSDATA`` / ``GETFORCE`` / ``EXIT``, the driver answers ``READY`` /
``NEEDINIT`` / ``HAVEDATA`` / ``FORCEREADY`` with binary payloads. The
wire carries atomic units (bohr, hartree), and cell matrices cross it
transposed (lattice vectors as columns). i-PI sends no atomic species:
the driver takes them from a template structure in the server's atom
order.
"""

from __future__ import annotations

import logging
import socket
from typing import Optional, Sequence

import numpy as np

from .utils.logging import ROOT_LOGGER

logger = logging.getLogger(ROOT_LOGGER + ".ipi")

BOHR = 0.529177210903  # Angstrom
HARTREE = 27.211386245988  # eV

_HDRLEN = 12


def _recvall(conn: socket.socket, nbytes: int) -> bytes:
    chunks = []
    remaining = nbytes
    while remaining:
        chunk = conn.recv(remaining)
        if not chunk:
            raise ConnectionError("i-PI server closed the connection")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def _send_header(conn: socket.socket, msg: str) -> None:
    conn.sendall(msg.ljust(_HDRLEN).encode("ascii"))


def _recv_header(conn: socket.socket) -> str:
    return _recvall(conn, _HDRLEN).decode("ascii").strip()


def _recv_array(conn: socket.socket, count: int, dtype) -> np.ndarray:
    itemsize = np.dtype(dtype).itemsize
    return np.frombuffer(_recvall(conn, count * itemsize), dtype=dtype).copy()


def connect(address: str = "localhost", port: int = 31415, unixsocket: Optional[str] = None,
            timeout: Optional[float] = None) -> socket.socket:
    """Connect to an i-PI server at ``address:port`` or on a unix socket
    (a bare name is ``/tmp/ipi_<name>``, i-PI's convention)."""
    if unixsocket is not None:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(timeout)
        try:
            conn.connect(unixsocket if "/" in unixsocket else f"/tmp/ipi_{unixsocket}")
        except OSError:
            conn.close()
            raise
        return conn
    return socket.create_connection((address, port), timeout=timeout)


def run_driver(calculator, types: Sequence[int], address: str = "localhost",
               port: int = 31415, unixsocket: Optional[str] = None,
               pbc: Optional[np.ndarray] = None, max_steps: Optional[int] = None,
               timeout: Optional[float] = None) -> int:
    """Drive an i-PI simulation: receive positions, return energy, forces
    and virial until the server sends ``EXIT``.

    :param calculator: a :class:`~.calculator.Calculator` (or anything
        with its ``compute(system, forces, stress)``).
    :param types: atomic numbers in the server's atom order.
    :param pbc: periodic flags; by default periodic where the received
        cell is not zero.
    :param max_steps: stop after this many force calls.
    :return: the number of force calls served.
    """
    from .containers import System

    types = np.asarray(types, dtype=np.int32)
    conn = connect(address, port, unixsocket, timeout)
    logger.info("connected to i-PI server (%s)", unixsocket or f"{address}:{port}")
    initialized = False
    result = None
    n_evaluated = 0
    try:
        while True:
            header = _recv_header(conn)
            if header == "STATUS":
                if not initialized:
                    _send_header(conn, "NEEDINIT")
                elif result is not None:
                    _send_header(conn, "HAVEDATA")
                else:
                    _send_header(conn, "READY")
            elif header == "INIT":
                _recv_array(conn, 1, np.int32)  # bead index
                nbytes = int(_recv_array(conn, 1, np.int32)[0])
                if nbytes:
                    _recvall(conn, nbytes)
                initialized = True
            elif header == "POSDATA":
                cell_wire = _recv_array(conn, 9, np.float64).reshape(3, 3)
                _recv_array(conn, 9, np.float64)  # the inverse cell, unused
                natoms = int(_recv_array(conn, 1, np.int32)[0])
                if natoms != len(types):
                    raise ValueError(
                        f"i-PI server sent {natoms} atoms; the template has {len(types)}")
                positions = _recv_array(conn, 3 * natoms, np.float64).reshape(natoms, 3)
                cell = cell_wire.T * BOHR  # columns -> rows, bohr -> A
                periodic = pbc if pbc is not None else np.full(3, bool(np.abs(cell).sum() > 0))
                system = System(positions=positions * BOHR, types=types, cell=cell,
                                pbc=np.asarray(periodic, dtype=bool))
                stress = bool(np.asarray(periodic).any())
                result = calculator.compute(system, forces=True, stress=stress)
                if not stress:
                    result["virial"] = np.zeros((3, 3))
                n_evaluated += 1
            elif header == "GETFORCE":
                if result is None:
                    raise RuntimeError("GETFORCE before POSDATA")
                _send_header(conn, "FORCEREADY")
                forces_au = np.asarray(result["forces"]) / (HARTREE / BOHR)
                virial_au = np.asarray(result["virial"]) / HARTREE
                conn.sendall(np.float64(result["energy"] / HARTREE).tobytes()
                             + np.int32(len(types)).tobytes()
                             + forces_au.astype(np.float64).tobytes()
                             + virial_au.T.astype(np.float64).tobytes()
                             + np.int32(0).tobytes())  # no extra string
                result = None
                if max_steps is not None and n_evaluated >= max_steps:
                    break
            elif header == "EXIT":
                logger.info("i-PI server sent EXIT after %d steps", n_evaluated)
                break
            else:
                raise ValueError(f"unknown i-PI header {header!r}")
    finally:
        conn.close()
    return n_evaluated
