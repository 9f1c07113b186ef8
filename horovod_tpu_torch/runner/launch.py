"""``hvdtpu-run-torch`` CLI -- the ``horovodrun`` equivalent of the port.

The port of the JAX package's ``runner/launch.py``. Parity:
``horovod/runner/launch.py`` (arg surface ``:247-438``, ``_run_static:527``,
``_run_elastic:619``, ``run_commandline:761``). Static jobs parse ``-H
host1:4,host2:4`` (or count this machine's cards) and fan out one process
per slot; elastic jobs poll a discovery script and drive restarts
through the elastic driver::

    python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \
        python train.py

Config knobs follow the reference's flag->env convention
(``horovod/runner/common/util/config_parser.py``); ``--timeline-*``
becomes ``HVDTPU_TIMELINE`` / ``_TIMELINE_MARK_CYCLES``
(:mod:`..utils.timeline`); ``--autotune`` and ``--autotune-log-file``
become ``HVDTPU_AUTOTUNE`` and ``HVDTPU_AUTOTUNE_LOG``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

from . import api
from .hosts import HostInfo, discover_local_hosts, parse_hosts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hvdtpu-run-torch",
        description="Launch a horovod_tpu_torch job, one process per card.",
    )
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="total process (card) count; default: all discovered")
    p.add_argument("-H", "--hosts", default=None,
                   help="comma-separated host:slots list")
    p.add_argument("--hostfile", default=None,
                   help="file with one host:slots per line")
    p.add_argument("--verbose", "-v", action="store_true")
    # Elastic (parity: --min-np/--max-np/--host-discovery-script).
    p.add_argument("--min-np", type=int, default=None)
    p.add_argument("--max-np", type=int, default=None)
    p.add_argument("--host-discovery-script", default=None)
    p.add_argument("--reset-limit", type=int, default=None)
    # Control-plane high availability: durable KV/driver journal and
    # the crash-adoption restart path (see docs/elastic.md).
    p.add_argument("--journal-dir", default=None,
                   help="directory for the durable control-plane journal "
                        "(HVDTPU_JOURNAL_DIR)")
    p.add_argument("--adopt", action="store_true",
                   help="adopt a crashed/preempted driver's journaled state "
                        "and its still-running workers (needs --journal-dir)")
    # Perf knobs → env (config_parser.py convention).
    p.add_argument("--fusion-threshold-mb", type=int, default=None)
    p.add_argument("--cycle-time-ms", type=float, default=None)
    p.add_argument("--cache-capacity", type=int, default=None)
    p.add_argument("--timeline-filename", default=None)
    p.add_argument("--timeline-mark-cycles", action="store_true")
    p.add_argument("--no-stall-check", action="store_true")
    p.add_argument("--stall-warning-time-seconds", type=float, default=None)
    p.add_argument("--autotune", action="store_true")
    p.add_argument("--autotune-log-file", default=None)
    p.add_argument("--network-interface", "--nics", dest="network_interface",
                   default=None,
                   help="NIC name to advertise/bind rendezvous and peer-mesh "
                        "links on (multi-homed hosts). Sets HVDTPU_IFACE. "
                        "Parity: reference --network-interface(s).")
    p.add_argument("--log-level", default=None,
                   choices=["trace", "debug", "info", "warning", "error"],
                   help="workers' log level (HVT_LOG_LEVEL; reference "
                        "--log-level)")
    p.add_argument("--start-timeout", type=int, default=None,
                   help="seconds workers may take to form the world "
                        "(reference --start-timeout)")
    p.add_argument("--output-filename", default=None,
                   help="redirect worker output to "
                        "<dir>/rank.<N>/stdout|stderr (reference layout)")
    p.add_argument("--config-file", default=None,
                   help="YAML config (reference --config-file schema); "
                        "explicit CLI flags win over file values")
    p.add_argument("-cb", "--check-build", action="store_true",
                   help="print available frameworks/controllers/"
                        "operations and exit (reference --check-build)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command to run")
    return p


def check_build() -> str:
    """Capability report (parity: ``horovodrun --check-build``, reference
    ``launch.py:110-147``): the port's framework, its card toolchain and
    its ``torch.distributed`` backends."""
    import importlib.util
    import shutil

    import torch
    import torch.distributed as dist

    def mark(avail: bool) -> str:
        return "X" if avail else " "

    def has(mod: str) -> bool:
        return importlib.util.find_spec(mod) is not None

    cuda = torch.cuda.is_available()
    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if os.path.exists("/usr/local/cuda/bin/nvcc") else None)
    return f"""\
horovod_tpu_torch (torch {torch.__version__}, CUDA {torch.version.cuda}):

Available Frameworks:
    [{mark(True)}] PyTorch
    [{mark(has('triton'))}] Triton

Available Devices:
    [{mark(cuda)}] CUDA card ({torch.cuda.device_count() if cuda else 0} visible)
    [{mark(nvcc is not None)}] nvcc (builds csrc/*.cu for sm_90a)

Available Controllers:
    [{mark(dist.is_available())}] torch.distributed (rendezvous over the launcher's KV)

Available Tensor Operations:
    [{mark(dist.is_available() and dist.is_nccl_available())}] NCCL
    [{mark(dist.is_available() and dist.is_gloo_available())}] gloo"""


def _args_to_env(args) -> Dict[str, str]:
    """Flag → HVDTPU_* env mapping (reference config_parser.py)."""
    env: Dict[str, str] = {}
    if args.fusion_threshold_mb is not None:
        env["HVDTPU_FUSION_THRESHOLD"] = str(args.fusion_threshold_mb * 1024 * 1024)
    if args.cycle_time_ms is not None:
        env["HVDTPU_CYCLE_TIME"] = str(args.cycle_time_ms)
    if args.cache_capacity is not None:
        env["HVDTPU_CACHE_CAPACITY"] = str(args.cache_capacity)
    if args.timeline_filename:
        env["HVDTPU_TIMELINE"] = args.timeline_filename
    if args.timeline_mark_cycles:
        env["HVDTPU_TIMELINE_MARK_CYCLES"] = "1"
    if args.autotune:
        env["HVDTPU_AUTOTUNE"] = "1"
    if args.autotune_log_file:
        env["HVDTPU_AUTOTUNE_LOG"] = args.autotune_log_file
    if args.no_stall_check:
        env["HVDTPU_STALL_CHECK_DISABLE"] = "1"
    if args.stall_warning_time_seconds is not None:
        env["HVDTPU_STALL_CHECK_TIME_SECONDS"] = str(
            args.stall_warning_time_seconds
        )
    if args.network_interface:
        env["HVDTPU_IFACE"] = args.network_interface
    if args.start_timeout is not None:
        env["HVT_INIT_TIMEOUT_SECONDS"] = str(args.start_timeout)
    if args.log_level:
        env["HVT_LOG_LEVEL"] = args.log_level
    return env


def _resolve_hosts(args):
    if args.hosts:
        return parse_hosts(args.hosts)
    if args.hostfile:
        with open(args.hostfile) as f:
            return parse_hosts(",".join(l.strip() for l in f if l.strip()))
    return discover_local_hosts()


def run_commandline(argv: List[str] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.check_build:
        print(check_build())
        return 0
    if args.config_file is not None:
        from .config_parser import apply_config_file

        apply_config_file(args, parser)
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("hvdtpu-run-torch: no command given", file=sys.stderr)
        return 2

    env = _args_to_env(args)
    elastic = bool(
        args.host_discovery_script or args.min_np or args.max_np or args.adopt
    )
    if elastic:
        from .elastic_driver import run_elastic

        return run_elastic(
            command,
            discovery_script=args.host_discovery_script,
            min_np=args.min_np or 1,
            max_np=args.max_np,
            reset_limit=args.reset_limit,
            extra_env=env,
            verbose=args.verbose,
            output_dir=args.output_filename,
            journal_dir=args.journal_dir,
            adopt=args.adopt,
        )

    hosts = _resolve_hosts(args)
    if args.num_proc:
        # Trim the slots to the requested process count (one process a
        # slot: the last host kept may run fewer processes than it has
        # cards).
        total, kept = 0, []
        for h in hosts:
            if total >= args.num_proc:
                break
            take = min(h.slots, args.num_proc - total)
            kept.append(HostInfo(h.hostname, take))
            total += take
        if total < args.num_proc:
            print(
                f"hvdtpu-run-torch: requested -np {args.num_proc} but hosts "
                f"provide {total} slots",
                file=sys.stderr,
            )
            return 2
        hosts = kept
    if args.verbose:
        print("hvdtpu-run-torch: hosts="
              f"{[(h.hostname, h.slots) for h in hosts]}")
    return api.launch_job(
        command, hosts, extra_env=env, output_dir=args.output_filename
    )


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
