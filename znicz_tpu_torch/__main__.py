"""The command line: ``python -m znicz_tpu_torch <workflow> [<config>]``
(port of ``znicz_tpu/__main__.py``).

Imports the config module (it sets leaves of the global ``root`` tree),
applies the ``--root key=value`` overrides (values read as Python
literals where they parse), seeds the generators, imports the workflow
module and drives its ``run(load, main)`` through a
:class:`~znicz_tpu_torch.launcher.Launcher`.  ``<workflow>`` is a file
path, a dotted module name or a bare sample name (``cifar`` →
``znicz_tpu_torch.models.samples.cifar``)::

    python -m znicz_tpu_torch cifar                       # on the card
    python -m znicz_tpu_torch cifar -b cpu --root cifar.max_epochs=1
    python -m znicz_tpu_torch wine -b numpy               # the numpy oracle
    python -m znicz_tpu_torch cifar -s <snapshot.pickle.gz>  # resume
    python -m znicz_tpu_torch cifar --chunk 16            # 16 steps a dispatch
    python -m znicz_tpu_torch cifar --dump-graph cifar.dot

``-b/--backend`` takes ``cuda`` (the default: the card, an error when
there is none), ``cpu`` or ``numpy`` (the numpy oracle: every unit's
``numpy_run``; its snapshots resume on the CPU and on the card).  ``--chunk N`` trains through
``run_chunked(N)`` (N steps a region dispatch: on the card, N replays
of the step's CUDA graph).  ``--dump-graph FILE`` builds and
initializes the workflow on the device, writes its unit graph as
Graphviz DOT (the ``train_region`` unit included) and exits without
training.  ``--listen HOST:PORT`` (process 0) or ``--master HOST:PORT``
(the others), with ``--nodes N`` and ``--process-id I``, train one
workflow over N processes (one card each under NCCL, or gloo ranks with
``-b cpu``), the reference's distributed mode; ``--n-model M`` splits
the model-parallel layers over M of them::

    python -m znicz_tpu_torch wine -b cpu --listen 127.0.0.1:29500 --nodes 2 --process-id 0
    python -m znicz_tpu_torch wine -b cpu --master 127.0.0.1:29500 --nodes 2 --process-id 1

The reference's search and dashboard flags are in the parser and raise,
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import ast
import importlib
import importlib.util
import logging
import os
import sys

from znicz_tpu_torch.launcher import Launcher, not_ported
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import root
from znicz_tpu_torch.utils.logger import Logger, setup_logging

SAMPLES_PACKAGE = "znicz_tpu_torch.models.samples"

#: flags of the reference's parser the port has not ported: attribute →
#: (flag, what it does, the ROADMAP item that ports it)
UNPORTED_FLAGS = {
    "optimize": ("--optimize", "the genetic hyper-parameter search", "A13"),
    "web_status": ("--web-status", "the web status page", "A12"),
}


def _import_module(spec: str, kind: str):
    """Import by file path, dotted name or bare sample name."""
    if os.sep in spec or spec.endswith(".py"):
        path = os.path.abspath(spec)
        if not os.path.exists(path):
            raise FileNotFoundError(f"{kind} file not found: {spec}")
        name = os.path.splitext(os.path.basename(path))[0]
        mod_spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(mod_spec)
        sys.modules[name] = module  # before exec, so its classes pickle
        mod_spec.loader.exec_module(module)
        return module
    try:
        return importlib.import_module(spec)
    except ModuleNotFoundError as exc:
        # the samples package only when the missing module is the one
        # asked for (not a dependency it failed to import)
        if exc.name != spec.split(".")[0] and exc.name != spec:
            raise
    return importlib.import_module(f"{SAMPLES_PACKAGE}.{spec}")


def _apply_root_overrides(pairs: list[str]) -> None:
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--root expects key=value, got '{pair}'")
        key, raw = pair.split("=", 1)
        stripped = raw.strip()
        if stripped.startswith("Tune(") and stripped.endswith(")"):
            raise not_ported(f"--root {key}=Tune(...): the genetic "
                             f"hyper-parameter search", "A13")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw  # a plain string leaf
        node = root
        parts = key.split(".")
        if parts[0] == "root":
            parts = parts[1:]
        for part in parts[:-1]:
            node = getattr(node, part)
        setattr(node, parts[-1], value)


def _list_samples() -> list[str]:
    pkg = importlib.import_module(SAMPLES_PACKAGE)
    return [entry[:-3] for entry in sorted(os.listdir(
        os.path.dirname(pkg.__file__)))
        if entry.endswith(".py") and not entry.startswith("_")
        and not entry.endswith("_config.py")]


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="znicz_tpu_torch",
        description="Veles/Znicz on PyTorch and CUDA: run a workflow "
                    "(the reference's `veles <workflow.py> <config.py>`)")
    p.add_argument("workflow", nargs="?",
                   help="workflow .py file, module, or sample name")
    p.add_argument("config", nargs="?",
                   help="config .py file/module setting the root tree")
    p.add_argument("-s", "--snapshot", help="resume from a snapshot file")
    p.add_argument("-b", "--backend", choices=("cuda", "cpu", "numpy"),
                   help="device (default: the card, an error without "
                        "one; numpy: the numpy oracle)")
    p.add_argument("-l", "--listen", metavar="HOST:PORT",
                   help="coordinate a multi-process run (process 0; the "
                        "reference's master --listen)")
    p.add_argument("-m", "--master", metavar="HOST:PORT",
                   help="join a multi-process run (the reference's slave "
                        "--master)")
    p.add_argument("--nodes", type=int, help="total process count")
    p.add_argument("--process-id", type=int,
                   help="this process's index")
    p.add_argument("--retries", type=int, default=0,
                   help="auto-resume attempts after a crash")
    p.add_argument("--seed", type=int, help="override root.common.seed")
    p.add_argument("--root", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="config-leaf override (repeatable), e.g. "
                        "--root cifar.learning_rate=0.01")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="debug-level logging")
    p.add_argument("--web-status", type=int, metavar="PORT",
                   help="live status page (not ported)")
    p.add_argument("--optimize", metavar="GENSxPOP",
                   help="genetic hyper-parameter search (not ported)")
    p.add_argument("--chunk", type=int, metavar="N",
                   help="train N steps per region dispatch "
                        "(StandardWorkflow.run_chunked)")
    p.add_argument("--n-model", type=int, default=1, metavar="M",
                   help="model-axis size of the process grid (tensor "
                        "parallelism: layers with model_parallel="
                        "'column'/'row' split over it; requires "
                        "--listen/--master)")
    p.add_argument("--dump-graph", metavar="FILE",
                   help="initialize the workflow, write its unit graph as "
                        "Graphviz DOT and exit")
    p.add_argument("--dry-run", action="store_true",
                   help="build and initialize only; do not train")
    p.add_argument("--list-samples", action="store_true",
                   help="list the bundled sample workflows and exit")
    return p


class Main(Logger):
    """The command line (the reference's ``Main``)."""

    def run(self, argv: list[str] | None = None) -> int:
        args = make_parser().parse_args(argv)
        setup_logging(logging.DEBUG if args.verbose else logging.INFO)
        for attr, (flag, what, item) in UNPORTED_FLAGS.items():
            if getattr(args, attr) is not None:
                raise not_ported(f"{flag}: {what}", item)
        if args.list_samples:
            print("\n".join(_list_samples()))
            return 0
        if not args.workflow:
            make_parser().print_usage()
            return 2
        if args.config:
            imported = set(sys.modules)
            config = _import_module(args.config, "config")
            if config.__name__ in imported:
                # a config module works by setting leaves of root: run
                # it again on a later call in this process (a reset
                # root would otherwise miss them)
                importlib.reload(config)
        _apply_root_overrides(args.root)
        if args.seed is not None:
            root.common.seed = args.seed
        prng.seed_all(int(root.common.seed))

        module = _import_module(args.workflow, "workflow")
        run_fn = getattr(module, "run", None)
        if run_fn is None:
            self.error("workflow module %s has no run(load, main)",
                       module.__name__)
            return 1
        launcher = Launcher(backend=args.backend, snapshot=args.snapshot,
                            retries=args.retries, chunk=args.chunk,
                            listen=args.listen, master=args.master,
                            n_processes=args.nodes,
                            process_id=args.process_id,
                            n_model=args.n_model)
        self.launcher = launcher  # for tests and embedding callers
        if args.dry_run or args.dump_graph:
            def initialize_only(**kwargs):
                wf = launcher.workflow
                wf.initialize(device=launcher.make_device(), **kwargs)
                if launcher._snapshot_state is not None:
                    # the staged snapshot must apply
                    wf.load_state(launcher._snapshot_state)
                    launcher._snapshot_state = None

            run_fn(launcher._load, initialize_only)
            if args.dump_graph:
                with open(args.dump_graph, "w") as f:
                    f.write(launcher.workflow.generate_graph())
                self.info("graph → %s", args.dump_graph)
            launcher.shutdown()
            return 0
        try:
            launcher.boot(run_fn)
        except KeyboardInterrupt:
            self.warning("interrupted")
            return 130
        launcher.shutdown()
        return 0


def main(argv: list[str] | None = None) -> int:
    return Main().run(argv)


if __name__ == "__main__":
    sys.exit(main())
