"""The command line of the port: ``python -m metatrain_tpu_torch <command>``.

Counterpart of ``metatrain_tpu/__main__.py`` for its ``train``, ``eval``,
``drive``, ``serve``, ``defaults`` and ``export`` subcommands, with their
arguments: ``train`` writes into a timestamped ``outputs/<date>/<time>/``
(``train.log``, the checkpoints), and any command that fails writes
``error.log`` there (the others: in the working directory) and re-raises.
``eval``, ``drive`` and ``serve`` also take ``--device`` (default
``auto``: the first card, and an error without one). Options files may be
JSON, read without PyYAML (``utils.config``); ``defaults`` writes YAML
and needs PyYAML.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import sys
import traceback
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    from . import __version__

    parser = argparse.ArgumentParser(
        prog="python -m metatrain_tpu_torch",
        description="training and evaluation of atomistic ML models in PyTorch and CUDA",
    )
    parser.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)

    train = sub.add_parser("train", help="train a model from an options file")
    train.add_argument("options", help="options file (JSON, or YAML where PyYAML is installed)")
    train.add_argument("-o", "--output", default="model.mtt")
    train.add_argument("--restart", default=None,
                       help="checkpoint to restart from, or 'auto' for the most recent")
    train.add_argument("--profile", default=None, metavar="DIR",
                       help="write a torch.profiler trace of the training run into DIR")
    train.add_argument("-r", "--override", action="append", default=[],
                       help="dotlist override, e.g. -r architecture.training.num_epochs=10")

    evaluate = sub.add_parser("eval", help="evaluate an exported model")
    evaluate.add_argument("model", help="exported .mtt file or checkpoint")
    evaluate.add_argument("options", help="eval dataset options file")
    evaluate.add_argument("-o", "--output", default=None)
    evaluate.add_argument("-b", "--batch-size", type=int, default=16)
    evaluate.add_argument("--check-consistency", action="store_true")
    evaluate.add_argument("--warm-up", type=int, default=1, metavar="N",
                          help="number of untimed warm-up batches before the timed pass")
    evaluate.add_argument("--profile", default=None, metavar="DIR",
                          help="write a torch.profiler trace of the evaluation into DIR")
    evaluate.add_argument("--device", default="auto",
                          help="'auto' (the first CUDA device), 'cuda:N' or 'cpu'")

    drive = sub.add_parser("drive", help="serve force calls to an i-PI server")
    drive.add_argument("model", help="exported .mtt file or checkpoint")
    drive.add_argument("template", help="structure file giving the atom types in server order")
    drive.add_argument("--address", default="localhost")
    drive.add_argument("--port", type=int, default=31415)
    drive.add_argument("--unix", default=None, metavar="NAME",
                       help="unix socket: a path, or a bare name for /tmp/ipi_<NAME>")
    drive.add_argument("--device", default="auto",
                       help="'auto' (the first CUDA device), 'cuda:N' or 'cpu'")

    serve = sub.add_parser("serve", help="socket force server for MD-engine coupling (LAMMPS "
                                          "fix external adapter in examples/lammps/)")
    serve.add_argument("model", help="exported .mtt file or checkpoint")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=31415)
    serve.add_argument("--unix", default=None, metavar="PATH", help="unix socket path")
    serve.add_argument("--persist", action="store_true",
                       help="keep listening after a client disconnects")
    serve.add_argument("--device", default="auto",
                       help="'auto' (the first CUDA device), 'cuda:N' or 'cpu'")

    defaults = sub.add_parser("defaults", help="print an architecture's default hypers as an "
                                               "options-file skeleton (YAML; needs PyYAML)")
    defaults.add_argument("architecture", nargs="?", default=None,
                          help="architecture name; omit to list all")
    defaults.add_argument("-o", "--output", default=None,
                          help="write the YAML skeleton to a file instead of stdout")

    export = sub.add_parser("export", help="export a checkpoint")
    export.add_argument("checkpoint",
                        help="checkpoint path, URL, or hf://<org>/<repo>/<file> reference")
    export.add_argument("-o", "--output", default="model.mtt")
    export.add_argument("-m", "--metadata", default=None,
                        help="JSON or YAML file with metadata to merge into the exported model")
    export.add_argument("-r", "--revision", "-b", "--branch", dest="revision", default=None,
                        help="HF-Hub revision/branch for hf:// checkpoint references")
    export.add_argument("--token", default=None,
                        help="HF-Hub access token (defaults to $HF_TOKEN)")
    return parser


def _apply_overrides(options: dict, overrides: list) -> dict:
    """Dotlist overrides ``key.sub=value``; the value is read as JSON, or
    as YAML where it is not JSON."""
    from .utils.config import parse_override_value

    for override in overrides:
        if "=" not in override:
            raise ValueError(f"override {override!r} must be key=value")
        key, value = override.split("=", 1)
        target = options
        parts = key.split(".")
        for part in parts[:-1]:
            target = target.setdefault(part, {})
        target[parts[-1]] = parse_override_value(value)
    return options


def _print_defaults(architecture, output) -> None:
    """The architecture names, or one architecture's default hypers as an
    options-file skeleton in YAML."""
    from .utils.architectures import available_architectures, get_default_hypers

    if architecture is None:
        print("\n".join(available_architectures()))
        return
    try:
        import yaml
    except ImportError:
        from .utils.config import MetatrainConfigError

        raise MetatrainConfigError(
            "defaults writes a YAML skeleton and needs PyYAML, which is not installed") from None
    skeleton = {
        "architecture": {"name": architecture, **get_default_hypers(architecture)},
        "training_set": {"systems": {"read_from": "dataset.xyz"},
                         "targets": {"energy": {"key": "energy"}}},
        "validation_set": 0.1,
        "test_set": 0.0,
    }
    text = yaml.safe_dump(skeleton, sort_keys=False)
    if output:
        Path(output).write_text(text)
    else:
        print(text, end="")


def main(argv=None) -> int:
    from .utils.config import load_options, read_mapping_file
    from .utils.logging import ROOT_LOGGER, setup_logging
    from .utils.profiling import profile_trace

    args = build_parser().parse_args(argv)
    if args.command == "train":
        now = datetime.datetime.now()
        output_dir = Path("outputs") / now.strftime("%Y-%m-%d") / now.strftime("%H-%M-%S")
        output_dir.mkdir(parents=True, exist_ok=True)
    else:
        output_dir = Path(".")

    with setup_logging(str(output_dir / "train.log") if args.command == "train" else None):
        try:
            if args.command == "train":
                from .cli.train import find_latest_checkpoint, train_model

                options = _apply_overrides(load_options(args.options), args.override)
                restart = find_latest_checkpoint() if args.restart == "auto" else args.restart
                with profile_trace(args.profile):
                    train_model(options, output_dir=".", checkpoint_dir=str(output_dir),
                                restart_from=restart, output_name=args.output)
            elif args.command == "eval":
                from .cli.eval import eval_model

                options = load_options(args.options)
                with profile_trace(args.profile):
                    eval_model(args.model, options, output_path=args.output,
                               batch_size=args.batch_size,
                               check_consistency=args.check_consistency,
                               warm_up=args.warm_up, device=args.device)
            elif args.command == "drive":
                from .calculator import Calculator
                from .data.readers import read_systems
                from .ipi import run_driver

                template = read_systems(args.template)[0]
                run_driver(Calculator(args.model, device=args.device), template.types,
                           address=args.address, port=args.port, unixsocket=args.unix,
                           pbc=template.pbc)
            elif args.command == "serve":
                from .serve import run_server

                run_server(args.model, unix=args.unix, host=args.host, port=args.port,
                           persist=args.persist, device=args.device)
            elif args.command == "defaults":
                _print_defaults(args.architecture, args.output)
            elif args.command == "export":
                from .cli.export import export_model

                metadata = read_mapping_file(args.metadata) if args.metadata else None
                export_model(args.checkpoint, args.output, metadata=metadata,
                             revision=args.revision, hf_token=args.token)
        except Exception:
            error_log = output_dir / "error.log"
            error_log.write_text(traceback.format_exc())
            logging.getLogger(ROOT_LOGGER).error(
                "command failed; full traceback in %s", error_log)
            raise
    return 0


if __name__ == "__main__":
    sys.exit(main())
