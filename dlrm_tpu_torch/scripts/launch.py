#!/usr/bin/env python3
"""Multi-process launcher for the port's trainers (the twin of
scripts/launch.py; the working analog of the reference's torchx ddp
component, torchrec_dlrm/aws_component.py:13-42).

Two modes:

  * single host (default): spawn --nproc local processes, each running the
    chosen trainer module (dlrm_tpu_torch.cli or dlrm_tpu_torch.v2_main)
    with torchrun's environment exported (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT); the trainers'
    parallel/multihost.py::init_multihost reads it (env://). With
    --device cuda (the default) each process is `python -m <module>` on
    the card cuda:LOCAL_RANK, the ranks joined over NCCL; more processes
    per host than the host has cards, or more than one host's processes,
    is refused before anything starts (NCCL takes one card per rank, and
    there is no CPU fallback). With --device cpu each process runs the
    module's main(argv, device="cpu"), the ranks joined over gloo, and
    every rank starts here (--nproc-per-host then groups them into
    emulated hosts).

  * --print-cmds: print the per-host command lines (rank and rendezvous
    environment) for a multi-host run whose processes an external scheduler
    starts, one host's --nproc-per-host ranks on each.

Mirrors the reference's shape constraint: trainer counts above one host
must be a multiple of the per-host process count (aws_component.py:25-29).
The first rank to exit with a non-zero code tears the others down, and its
code is returned.

Usage:
  python -m dlrm_tpu_torch.scripts.launch --nproc 2 -m dlrm_tpu_torch.cli \\
      -- --arch-embedding-size 100-200 --sharded ...
  python -m dlrm_tpu_torch.scripts.launch --nproc 4 --device cpu \\
      -m dlrm_tpu_torch.v2_main -- --sharded ...
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

# the child of --device cpu: the module's main on the CPU
_CPU_CHILD = ("import importlib, sys; "
              "m = importlib.import_module(sys.argv[1]); "
              "sys.exit(m.main(sys.argv[2:], device='cpu'))")
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="torchx-ddp-analog launcher (aws_component.py role)"
    )
    p.add_argument("--nproc", type=int, default=2,
                   help="total trainer processes (torchx num_trainers)")
    p.add_argument("--nproc-per-host", type=int, default=None,
                   help="processes per host (default: all local)")
    p.add_argument("-m", "--module", default="dlrm_tpu_torch.cli",
                   help="trainer module (dlrm_tpu_torch.cli or "
                   "dlrm_tpu_torch.v2_main)")
    p.add_argument("--coordinator", default=None,
                   help="host:port rendezvous address "
                   "(default: localhost:<free port>)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: a card per rank over NCCL; cpu: the trainer's "
                   "main(argv, device='cpu') over gloo")
    p.add_argument("--print-cmds", action="store_true",
                   help="print per-rank command lines instead of spawning "
                   "(multi-host scheduler integration)")
    p.add_argument("script_args", nargs=argparse.REMAINDER,
                   help="args after -- go to the trainer")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)

    per_host = args.nproc_per_host or args.nproc
    if args.nproc > per_host and args.nproc % per_host != 0:
        # aws_component.py:25-29's multiple-of-8 rule, generalized
        raise SystemExit(
            f"ERROR: {args.nproc} trainers spanning multiple hosts must be "
            f"a multiple of --nproc-per-host ({per_host})"
        )
    trainer_args = args.script_args
    if trainer_args and trainer_args[0] == "--":
        trainer_args = trainer_args[1:]
    if args.coordinator:
        addr, _, port = args.coordinator.rpartition(":")
    else:
        addr, port = "localhost", str(_free_port())

    def env_for(rank: int) -> dict:
        env = dict(os.environ)
        env.update({
            "MASTER_ADDR": addr, "MASTER_PORT": port,
            "WORLD_SIZE": str(args.nproc), "RANK": str(rank),
            "LOCAL_RANK": str(rank % per_host),
            "LOCAL_WORLD_SIZE": str(per_host),
        })
        # the JAX launcher's variable would be read as the process count
        env.pop("DLRM_NUM_PROCESSES", None)
        if args.nproc > 1:
            # one thread a rank unless the caller says otherwise, as
            # torchrun does: ranks that each take every core spin against
            # each other in their collectives
            env.setdefault("OMP_NUM_THREADS", "1")
        return env

    if args.device == "cuda":
        cmd = [sys.executable, "-m", args.module] + trainer_args
    else:
        cmd = [sys.executable, "-c", _CPU_CHILD, args.module] + trainer_args
    if args.print_cmds:
        for r in range(args.nproc):
            env = env_for(r)
            kv = " ".join(f"{k}={env[k]}" for k in ENV_KEYS)
            print(f"host {r // per_host} rank {r}: {kv} " + " ".join(cmd))
        return 0
    if args.device == "cuda":
        import torch

        cards = torch.cuda.device_count()
        if per_host > cards:
            raise RuntimeError(
                f"--device cuda: {per_host} ranks on this host but "
                f"torch.cuda.device_count() is {cards}; NCCL takes one card "
                "a rank (pass --device cpu to run on the CPU)")
        if args.nproc > per_host:
            raise RuntimeError(
                "--device cuda starts one host's ranks; start each host's "
                "with the lines of --print-cmds")

    procs = []
    try:
        # on the CPU every rank starts here, --nproc-per-host emulating the
        # hosts (LOCAL_RANK / LOCAL_WORLD_SIZE group the ranks into nodes)
        for r in range(args.nproc):
            procs.append(subprocess.Popen(cmd, env=env_for(r)))
        # fail-fast supervision (the torchelastic role this launcher
        # mirrors): one dead trainer leaves its peers blocked in
        # collectives forever, so on the FIRST non-zero exit the group is
        # torn down and that rank's code is reported
        live = set(range(len(procs)))
        while live:
            for r in sorted(live):
                code = procs[r].poll()
                if code is None:
                    continue
                live.discard(r)
                if code != 0:
                    print(
                        f"launch: rank {r} exited with code {code}; "
                        "terminating remaining ranks",
                        file=sys.stderr,
                    )
                    for pr in procs:
                        if pr.poll() is None:
                            pr.terminate()
                    for pr in procs:
                        pr.wait()
                    return code
            if live:
                time.sleep(0.2)
        return 0
    except KeyboardInterrupt:
        for pr in procs:
            if pr.poll() is None:
                pr.send_signal(signal.SIGINT)
        for pr in procs:
            pr.wait()
        return 130
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()


if __name__ == "__main__":
    sys.exit(main())
