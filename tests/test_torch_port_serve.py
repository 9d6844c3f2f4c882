"""Port parity: the MD-engine servers (``serve``, ``drive``) and their CLI vs the JAX package.

On the CPU, one float64 PET (tiny widths, random weights) exported by the
JAX package as a ``.mtt``; the port builds its model from that checkpoint
through ``interop.jax_params``; each package serves it with its own
``Calculator`` in float64 (the JAX one on the plain layout), on a
periodic 32-atom Cu cell:

- ``serve``: the two servers' answers over the wire (energy, forces,
  virial) agree to 1e-10, for each package's ``ForceClient`` against each
  server; a bad magic gets the same error frame from both, a failed call
  an error frame; ``persist`` serves a second client;
- ``drive``: each package's i-PI driver against the same minimal i-PI
  server (INIT, then POSDATA / GETFORCE rounds): the answers in atomic
  units agree to 1e-10, and equal the calculator's through the units;
- the command line: ``drive``, ``serve`` and ``defaults`` have the JAX
  package's options and defaults, plus ``--device``; ``defaults pet``
  prints the JAX package's skeleton and names PyYAML where it is missing;
  ``serve`` and ``drive`` from a ``.mtt`` run with ``--device cpu`` and
  raise with ``auto`` (the default) without a card.
"""

import contextlib
import io
import socket
import struct
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metatrain_tpu.__main__ as jmain
import metatrain_tpu.ipi as jipi
import metatrain_tpu.serve as jserve
import metatrain_tpu_torch.__main__ as tmain
import metatrain_tpu_torch.ipi as tipi
import metatrain_tpu_torch.serve as tserve
from conftest import make_crystal
from metatrain_tpu.calculator import Calculator as JaxCalculator
from metatrain_tpu.cli.export import export_model_object as jax_export
from metatrain_tpu.data.target_info import DatasetInfo as JaxDatasetInfo
from metatrain_tpu.data.target_info import get_energy_target_info as jax_energy_info
from metatrain_tpu.models.pet import PET as JaxPET
from metatrain_tpu.utils import io as jio
from metatrain_tpu_torch.calculator import Calculator
from metatrain_tpu_torch.containers import System
from metatrain_tpu_torch.data.readers.extxyz import write_xyz
from metatrain_tpu_torch.interop.jax_params import pet_from_checkpoint
from metatrain_tpu_torch.utils import config as tconfig

TOL = 1e-10  # float64 in both packages
MODEL = {"d_pet": 16, "d_node": 16, "d_head": 16, "d_feedforward": 16, "num_heads": 2,
         "num_gnn_layers": 1, "num_attention_layers": 1, "cutoff": 4.5}


def _cell(seed=4):
    s = make_crystal(n_cells=2, seed=seed, jitter=0.1)
    return System(s.positions, s.types, s.cell, s.pbc)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX package's ``.mtt`` and a float64 calculator of each package on it."""
    info = JaxDatasetInfo("angstrom", [29], {"energy": jax_energy_info("eV", True, True)})
    model = JaxPET(MODEL, info, compute_dtype=jnp.float64)
    model.init_params(jax.random.PRNGKey(3))
    model.params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), model.params)
    path = str(tmp_path_factory.mktemp("serve") / "model.mtt")
    jax_export(model, None, path)

    envelope = jio.load_checkpoint_file(path)
    port = pet_from_checkpoint(envelope["checkpoint"], compute_dtype=torch.float64, device="cpu")
    loaded = jio.load_model(path)
    jax_model = JaxPET(loaded.hypers, loaded.dataset_info, compute_dtype=jnp.float64)
    jax_model.params = loaded.params
    jax_model.composition, jax_model.scaler = loaded.composition, loaded.scaler
    return {"path": path,
            "port": Calculator(port, dtype=torch.float64),
            "jax": JaxCalculator(jax_model, dtype=jnp.float64, colored=False)}


@contextlib.contextmanager
def running(module, calculator, path, persist=False):
    """``module.run_server`` on a unix socket in a thread; stopped on exit."""
    ready = threading.Event()
    listening = {}

    def target():
        try:
            module.run_server(None, unix=path, calculator=calculator, persist=persist,
                              ready_callback=lambda s: (listening.update(s=s), ready.set()))
        except OSError:  # the persistent server's socket shut down below
            pass

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    assert ready.wait(60)
    try:
        yield path
    finally:
        if persist:
            listening["s"].shutdown(socket.SHUT_RDWR)
        thread.join(timeout=60)
        assert not thread.is_alive()


def _requests(system, n=2):
    rng = np.random.default_rng(9)
    return [system.positions + rng.normal(0, 0.01, system.positions.shape) for _ in range(n)]


def _ask(client_module, sock, system, positions_list):
    client = client_module.ForceClient(unix=sock)
    try:
        return [client.compute(p, system.types, system.cell, system.pbc) for p in positions_list]
    finally:
        client.close()


def _assert_answers_close(ours, theirs, tol=TOL):
    for a, b in zip(ours, theirs):
        assert abs(a["energy"] - b["energy"]) <= tol * abs(b["energy"])
        for key in ("forces", "virial"):
            assert a[key].shape == b[key].shape
            assert np.abs(a[key] - b[key]).max() <= tol * np.abs(b[key]).max(), key


@pytest.mark.parametrize("client", ["port", "jax"])
def test_serve_matches_jax(served, tmp_path, client):
    """Each package's client against each server: the same answers."""
    system = _cell()
    requests = _requests(system)
    client_module = tserve if client == "port" else jserve
    answers = {}
    for side, module in (("port", tserve), ("jax", jserve)):
        with running(module, served[side], str(tmp_path / f"{side}.sock")) as sock:
            answers[side] = _ask(client_module, sock, system, requests)
    _assert_answers_close(answers["port"], answers["jax"])
    # the virial on the wire is -stress * volume, the calculator's
    direct = served["port"].compute(System(requests[-1], system.types, system.cell, system.pbc),
                                    stress=True)
    volume = abs(np.linalg.det(system.cell))
    assert np.abs(answers["port"][-1]["virial"] + direct["stress"] * volume).max() <= (
        TOL * np.abs(direct["virial"]).max())
    assert np.abs(answers["port"][-1]["forces"] - direct["forces"]).max() <= (
        TOL * np.abs(direct["forces"]).max())


def _raw_exchange(sock, payload):
    """Send raw bytes; return (status, message) of the error frame."""
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.connect(sock)
    try:
        conn.sendall(payload)
        status, = struct.unpack("<I", tserve._recv_exact(conn, 4))
        length, = struct.unpack("<I", tserve._recv_exact(conn, 4))
        return status, tserve._recv_exact(conn, length)
    finally:
        conn.close()


def _request_bytes(system, cell):
    return (b"MTTC" + struct.pack("<I", len(system)) + np.asarray(cell, "<f8").tobytes()
            + system.pbc.astype(np.uint8).tobytes() + system.types.astype("<i4").tobytes()
            + system.positions.astype("<f8").tobytes())


def test_error_frames_match_jax(served, tmp_path):
    system = _cell()
    frames = {}
    for side, module in (("port", tserve), ("jax", jserve)):
        with running(module, served[side], str(tmp_path / f"{side}.sock")) as sock:
            frames[side] = _raw_exchange(sock, b"NOPE" + b"\0" * 4)
        # a force call that fails: a periodic system with a zero cell
        with running(module, served[side], str(tmp_path / f"{side}_bad.sock")) as sock:
            frames[f"{side}_failed"] = _raw_exchange(sock, _request_bytes(system, np.zeros((3, 3))))
    assert frames["port"] == frames["jax"] == (1, b"bad magic (expected MTTC)")
    assert frames["port_failed"] == frames["jax_failed"]
    assert frames["port_failed"][0] == 1 and b"cell" in frames["port_failed"][1]


def test_persist_serves_another_client(served, tmp_path):
    system = _cell()
    requests = _requests(system, 1)
    with running(tserve, served["port"], str(tmp_path / "p.sock"), persist=True) as sock:
        first = _ask(tserve, sock, system, requests)
        second = _ask(jserve, sock, system, requests)
    _assert_answers_close(first, second, tol=0.0)


# ---- the i-PI driver ----------------------------------------------------------

HDR = 12


def _send(conn, msg):
    conn.sendall(msg.ljust(HDR).encode())


def _recv(conn, n):
    data = b""
    while len(data) < n:
        chunk = conn.recv(n - len(data))
        assert chunk
        data += chunk
    return data


def ipi_server(sock, system, positions_list, results):
    """A minimal i-PI server: INIT, then POSDATA + GETFORCE per position set."""
    conn, _ = sock.accept()
    try:
        _send(conn, "STATUS")
        assert _recv(conn, HDR).strip() == b"NEEDINIT"
        _send(conn, "INIT")
        conn.sendall(np.int32(0).tobytes() + np.int32(0).tobytes())
        for positions in positions_list:
            _send(conn, "STATUS")
            assert _recv(conn, HDR).strip() == b"READY"
            _send(conn, "POSDATA")
            conn.sendall((system.cell / tipi.BOHR).T.astype(np.float64).tobytes()
                         + np.zeros((3, 3)).tobytes()  # the inverse cell, unused
                         + np.int32(len(system)).tobytes()
                         + (positions / tipi.BOHR).astype(np.float64).tobytes())
            _send(conn, "STATUS")
            assert _recv(conn, HDR).strip() == b"HAVEDATA"
            _send(conn, "GETFORCE")
            assert _recv(conn, HDR).strip() == b"FORCEREADY"
            energy = np.frombuffer(_recv(conn, 8), np.float64)[0]
            natoms = np.frombuffer(_recv(conn, 4), np.int32)[0]
            forces = np.frombuffer(_recv(conn, 24 * natoms), np.float64).reshape(natoms, 3)
            virial = np.frombuffer(_recv(conn, 72), np.float64).reshape(3, 3)
            assert np.frombuffer(_recv(conn, 4), np.int32)[0] == 0
            results.append({"energy": energy, "forces": forces.copy(), "virial": virial.copy()})
        _send(conn, "EXIT")
    finally:
        conn.close()


def drive(path, system, positions_list, run):
    """The i-PI server in a thread, ``run(path)`` (a driver) here; the
    server's answers."""
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.bind(path)
    sock.listen(1)
    results = []
    thread = threading.Thread(target=ipi_server, args=(sock, system, positions_list, results),
                              daemon=True)
    thread.start()
    try:
        run(path)
    finally:
        thread.join(timeout=60)
        sock.close()
    assert not thread.is_alive() and len(results) == len(positions_list)
    return results


def test_drive_matches_jax(served, tmp_path):
    system = _cell()
    requests = _requests(system, 3)
    answers = {}
    for side, module in (("port", tipi), ("jax", jipi)):
        answers[side] = drive(str(tmp_path / f"{side}.ipi"), system, requests, lambda path: (
            module.run_driver(served[side], system.types, unixsocket=path, pbc=system.pbc,
                              timeout=120)))
    _assert_answers_close(answers["port"], answers["jax"])
    # through the units: the calculator's answer at the positions the wire gave
    for answer, positions in zip(answers["port"], requests):
        seen = System((positions / tipi.BOHR) * tipi.BOHR, system.types, system.cell, system.pbc)
        ref = served["port"].compute(seen, stress=True)
        assert abs(answer["energy"] * tipi.HARTREE - ref["energy"]) <= TOL * abs(ref["energy"])
        forces = answer["forces"] * (tipi.HARTREE / tipi.BOHR)
        assert np.abs(forces - ref["forces"]).max() <= TOL * np.abs(ref["forces"]).max()
        virial = answer["virial"].T * tipi.HARTREE
        assert np.abs(virial - ref["virial"]).max() <= TOL * np.abs(ref["virial"]).max()
    assert (tipi.BOHR, tipi.HARTREE) == (jipi.BOHR, jipi.HARTREE)


# ---- the command line -----------------------------------------------------------


def _options_of(main_module, command):
    parser = main_module.build_parser()
    sub = next(a for a in parser._actions if a.dest == "command").choices[command]
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.required)
            for a in sub._actions if a.dest != "help"}


@pytest.mark.parametrize("command", ["drive", "serve", "defaults"])
def test_parsers_match_jax(command):
    ours, theirs = _options_of(tmain, command), _options_of(jmain, command)
    if command != "defaults":
        assert ours.pop("device") == (("--device",), "auto", None, None, False)
    assert ours == theirs


def test_defaults_prints_the_jax_skeleton(tmp_path, monkeypatch):
    printed = {}
    for side, main in (("port", tmain.main), ("jax", jmain.main)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(["defaults", "pet"]) == 0
        printed[side] = out.getvalue()
    assert printed["port"] == printed["jax"] and "d_pet" in printed["port"]
    monkeypatch.chdir(tmp_path)
    assert tmain.main(["defaults", "pet", "-o", "pet.yaml"]) == 0
    assert (tmp_path / "pet.yaml").read_text() == printed["jax"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tmain.main(["defaults"])
    assert out.getvalue().split() == ["pet"]
    monkeypatch.setitem(sys.modules, "yaml", None)  # any import of yaml now fails
    with pytest.raises(tconfig.MetatrainConfigError, match="PyYAML"):
        tmain.main(["defaults", "pet"])


@pytest.fixture
def template(tmp_path):
    system = _cell()
    path = str(tmp_path / "template.xyz")
    write_xyz(path, [system])
    return system, path


def test_serve_and_drive_commands_on_the_cpu(served, template, tmp_path, monkeypatch):
    """``serve`` and ``drive`` from the ``.mtt`` with ``--device cpu``
    answer as ``Calculator(path, device="cpu")``; with ``auto`` they need
    a card."""
    system, template_path = template
    monkeypatch.chdir(tmp_path)
    requests = _requests(system, 2)
    ref = Calculator(served["path"], device="cpu")
    expected = [ref.compute(System(p, system.types, system.cell, system.pbc), stress=True)
                for p in requests]

    sock = str(tmp_path / "cli.sock")
    thread = threading.Thread(target=tmain.main, daemon=True, args=(
        ["serve", served["path"], "--unix", sock, "--device", "cpu"],))
    thread.start()
    client = None
    for _ in range(600):
        try:
            client = tserve.ForceClient(unix=sock)
            break
        except (FileNotFoundError, ConnectionRefusedError):
            threading.Event().wait(0.1)
    answers = [client.compute(p, system.types, system.cell, system.pbc) for p in requests]
    client.close()
    thread.join(timeout=60)
    assert not thread.is_alive()
    for a, e in zip(answers, expected):
        assert a["energy"] == e["energy"] and np.array_equal(a["forces"], e["forces"])

    driven = drive(str(tmp_path / "cli.ipi"), system, requests, lambda path: tmain.main(
        ["drive", served["path"], template_path, "--unix", path, "--device", "cpu"]))
    for a, positions in zip(driven, requests):
        seen = System((positions / tipi.BOHR) * tipi.BOHR, system.types, system.cell, system.pbc)
        e = ref.compute(seen, stress=True)
        forces = a["forces"] * (tipi.HARTREE / tipi.BOHR)
        assert np.abs(forces - e["forces"]).max() <= 1e-6 * np.abs(e["forces"]).max()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["serve", served["path"], "--unix", str(tmp_path / "x.sock")],
                 ["drive", served["path"], template_path, "--unix", str(tmp_path / "x.ipi")]):
        with pytest.raises(RuntimeError, match="cpu"):
            tmain.main(argv)
    assert "RuntimeError" in (tmp_path / "error.log").read_text()


# ---- the LAMMPS client ------------------------------------------------------------

# A stand-in for LAMMPS behind examples/lammps/stub_include's headers: the
# client's main() builds it, reads the "deck" (here: the box, the types and
# the positions) and runs one step, whose callback asks the server.
LAMMPS_STANDIN = r"""
#include <cstdio>
#include <string>
#include <vector>
#include "lammps.h"
#include "atom.h"
#include "domain.h"
#include "fix_external.h"
#include "input.h"
#include "modify.h"
namespace LAMMPS_NS {
static LAMMPS *g_lmp;
static FixExternal g_fix;
static FixExternal::FnPtr g_callback;
static void *g_arg;
static double g_energy, g_virial[6];
static std::vector<double> g_x, g_f;
static int g_n;
LAMMPS::LAMMPS(int, char **, MPI_Comm) {
  g_lmp = this; atom = new Atom; domain = new Domain; input = new Input; modify = new Modify;
}
LAMMPS::~LAMMPS() {}
Fix::~Fix() {}
void FixExternal::set_callback(FnPtr fn, void *arg) { g_callback = fn; g_arg = arg; }
void FixExternal::set_energy_global(double e) { g_energy = e; }
void FixExternal::set_virial_global(double *v) { for (int i = 0; i < 6; ++i) g_virial[i] = v[i]; }
Fix *Modify::get_fix_by_id(const std::string &) const { return &g_fix; }
void Input::file(const char *path) {
  FILE *in = fopen(path, "r");
  Domain *d = g_lmp->domain;
  if (fscanf(in, "%d %lf %lf %lf %lf %lf %lf %d %d %d", &g_n, &d->xprd, &d->yprd, &d->zprd,
             &d->xy, &d->xz, &d->yz, &d->xperiodic, &d->yperiodic, &d->zperiodic) != 10) return;
  g_lmp->atom->type = new int[g_n];
  g_x.resize(3 * g_n);
  g_f.assign(3 * g_n, 0.0);
  for (int i = 0; i < g_n; ++i)
    if (fscanf(in, "%d %lf %lf %lf", &g_lmp->atom->type[i], &g_x[3 * i], &g_x[3 * i + 1],
               &g_x[3 * i + 2]) != 4) return;
  fclose(in);
}
char *Input::one(const char *) {
  std::vector<double *> x(g_n), f(g_n);
  for (int i = 0; i < g_n; ++i) { x[i] = &g_x[3 * i]; f[i] = &g_f[3 * i]; }
  g_callback(g_arg, 0, g_n, nullptr, x.data(), f.data());
  printf("%.17g\n", g_energy);
  for (int i = 0; i < 6; ++i) printf("%.17g\n", g_virial[i]);
  for (int i = 0; i < 3 * g_n; ++i) printf("%.17g\n", g_f[i]);
  return nullptr;
}
}  // namespace LAMMPS_NS
"""


@pytest.mark.skipif(__import__("shutil").which("g++") is None, reason="no g++")
def test_lammps_client_drives_the_port_server(served, tmp_path):
    """``examples/lammps/fix_mtt_client.cpp``, unchanged, built against a
    stand-in for LAMMPS, gets the port's answers over TCP."""
    import subprocess
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    (tmp_path / "standin.cpp").write_text(LAMMPS_STANDIN)
    binary = tmp_path / "lmp_mtt"
    build = subprocess.run(
        ["g++", "-std=c++17", "-O1", f"-I{repo / 'examples/lammps/stub_include'}",
         str(repo / "examples/lammps/fix_mtt_client.cpp"), str(tmp_path / "standin.cpp"),
         "-o", str(binary)], capture_output=True, text=True, timeout=120)
    assert build.returncode == 0, build.stderr
    system = _cell()
    deck = tmp_path / "deck.txt"
    cell = system.cell
    box = [cell[0, 0], cell[1, 1], cell[2, 2], cell[1, 0], cell[2, 0], cell[2, 1]]
    lines = [" ".join([str(len(system))] + [repr(float(v)) for v in box] + ["1", "1", "1"])]
    lines += [" ".join(["1"] + [repr(float(v)) for v in row]) for row in system.positions]
    deck.write_text("\n".join(lines) + "\n")

    ready = threading.Event()
    bound = {}
    thread = threading.Thread(target=tserve.run_server, daemon=True, kwargs=dict(
        model_path=None, host="127.0.0.1", port=0, calculator=served["port"],
        ready_callback=lambda s: (bound.update(port=s.getsockname()[1]), ready.set())))
    thread.start()
    assert ready.wait(60)
    run = subprocess.run([str(binary), str(deck), "127.0.0.1", str(bound["port"]), "29"],
                         capture_output=True, text=True, timeout=300)
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert run.returncode == 0, run.stderr
    values = np.array([float(v) for v in run.stdout.split()])
    ref = served["port"].compute(system, stress=True)
    virial = -ref["stress"] * abs(np.linalg.det(system.cell))
    assert values[0] == ref["energy"]
    assert np.array_equal(values[1:7], virial.reshape(-1)[[0, 4, 8, 1, 2, 5]])
    assert np.array_equal(values[7:].reshape(-1, 3), ref["forces"])
