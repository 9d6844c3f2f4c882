"""Socket force server for MD engines: ``python -m metatrain_tpu_torch serve``.

Counterpart of ``metatrain_tpu/serve.py``, with the same wire protocol
byte for byte, so the LAMMPS ``fix external`` client of
``examples/lammps/fix_mtt_client.cpp`` and the JAX package's
``ForceClient`` talk to this server unchanged. The model stays in one
process on the card (the kernels built, the device batch reused while the
Verlet-skin list holds: :class:`~.calculator.Calculator`), and each MD step
is one request.

Wire protocol (little-endian, one request per MD step)::

  client -> server:
      magic   4 bytes  b"MTTC"
      natoms  uint32
      cell    9 float64   (row-major cell matrix, Angstrom)
      pbc     3 uint8
      types   natoms int32   (atomic numbers)
      pos     natoms*3 float64 (Angstrom)
  server -> client:
      status  uint32      (0 = ok; 1 = error, followed by uint32 length
                           + utf-8 message, and the connection closes)
      energy  float64     (eV)
      virial  9 float64   (eV; -dE/dstrain, row-major)
      forces  natoms*3 float64 (eV/Angstrom)

Types may change between requests; the calculator then builds a new
batch. One client at a time; the server ends when the client disconnects
unless ``persist`` keeps it listening for the next one.
"""

from __future__ import annotations

import logging
import os
import socket
import struct
from typing import Optional

import numpy as np

from .utils.logging import ROOT_LOGGER

logger = logging.getLogger(ROOT_LOGGER + ".serve")

MAGIC = b"MTTC"


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client disconnected")
        buf += chunk
    return buf


def _send_error(conn: socket.socket, message: str) -> None:
    msg = message.encode()[:4096]
    conn.sendall(struct.pack("<I", 1) + struct.pack("<I", len(msg)) + msg)


def _serve_connection(conn: socket.socket, calculator) -> int:
    """Answer one client's requests until it disconnects or a request
    fails; returns the number of force calls served."""
    from .containers import System

    steps = 0
    while True:
        try:
            header = _recv_exact(conn, 8)
        except ConnectionError:
            return steps
        if header[:4] != MAGIC:
            _send_error(conn, "bad magic (expected MTTC)")
            return steps
        (natoms,) = struct.unpack("<I", header[4:])
        body = _recv_exact(conn, 9 * 8 + 3 + natoms * 4 + natoms * 24)
        cell = np.frombuffer(body[:72], "<f8").reshape(3, 3)
        pbc = np.frombuffer(body[72:75], np.uint8).astype(bool)
        types = np.frombuffer(body[75:75 + 4 * natoms], "<i4")
        positions = np.frombuffer(body[75 + 4 * natoms:], "<f8").reshape(natoms, 3)
        try:
            system = System(positions=positions.copy(), types=types.astype(np.int32),
                            cell=cell.copy(), pbc=pbc)
            out = calculator.compute(system, forces=True, stress=True)
            volume = float(abs(np.linalg.det(cell))) or 1.0
            # the calculator's stress is dE/dstrain / volume; the engine's
            # fix external takes the virial W = -dE/dstrain
            virial = -np.asarray(out["stress"], np.float64) * volume
        except Exception as err:  # noqa: BLE001 - the client gets the message
            logger.exception("force call failed")
            _send_error(conn, str(err))
            return steps
        conn.sendall(struct.pack("<I", 0) + struct.pack("<d", float(out["energy"]))
                     + np.asarray(virial, "<f8").tobytes()
                     + np.asarray(out["forces"], "<f8").tobytes())
        steps += 1


def run_server(model_path: Optional[str], unix: Optional[str] = None,
               host: str = "127.0.0.1", port: int = 31415, persist: bool = False,
               calculator=None, ready_callback=None, device="auto") -> None:
    """Serve force calls of ``model_path`` (``.mtt`` or checkpoint) on a
    unix socket or on ``host:port``.

    :param calculator: serve this calculator instead of loading the path.
    :param ready_callback: called with the listening socket.
    :param device: where the model loaded from the path runs: ``"auto"``
        (the first card; an error without one), ``"cuda:N"`` or ``"cpu"``.
    """
    if calculator is None:
        from .calculator import Calculator

        calculator = Calculator(model_path, device=device)
    if unix:
        server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        server.bind(unix)
        where = unix
    else:
        server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server.bind((host, port))
        where = f"{host}:{server.getsockname()[1]}"
    server.listen(1)
    logger.info("serve: listening on %s", where)
    if ready_callback is not None:
        ready_callback(server)
    try:
        while True:
            conn, _ = server.accept()
            with conn:
                steps = _serve_connection(conn, calculator)
            logger.info("client session done: %d force calls", steps)
            if not persist:
                break
    finally:
        server.close()
        if unix:
            try:
                os.unlink(unix)
            except OSError:
                pass


class ForceClient:
    """A client of the serve protocol, usable from any Python MD loop (the
    LAMMPS adapter in ``examples/lammps/`` speaks the same bytes)."""

    def __init__(self, unix=None, host="127.0.0.1", port=31415):
        self.sock = socket.socket(socket.AF_UNIX if unix else socket.AF_INET, socket.SOCK_STREAM)
        try:
            self.sock.connect(unix if unix else (host, port))
        except OSError:
            self.sock.close()
            raise

    def compute(self, positions, types, cell, pbc):
        """Energy (eV), virial ((3, 3), eV) and forces ((n, 3), eV/A)."""
        positions = np.ascontiguousarray(positions, "<f8")
        natoms = len(positions)
        self.sock.sendall(MAGIC + struct.pack("<I", natoms)
                          + np.ascontiguousarray(cell, "<f8").tobytes()
                          + np.ascontiguousarray(pbc, np.uint8).tobytes()
                          + np.ascontiguousarray(types, "<i4").tobytes()
                          + positions.tobytes())
        (status,) = struct.unpack("<I", _recv_exact(self.sock, 4))
        if status != 0:
            (length,) = struct.unpack("<I", _recv_exact(self.sock, 4))
            raise RuntimeError(_recv_exact(self.sock, length).decode())
        body = _recv_exact(self.sock, 8 + 72 + 24 * natoms)
        return {"energy": struct.unpack("<d", body[:8])[0],
                "virial": np.frombuffer(body[8:80], "<f8").reshape(3, 3),
                "forces": np.frombuffer(body[80:], "<f8").reshape(natoms, 3)}

    def close(self):
        self.sock.close()
