"""``python -m mxnet_tpu_torch.serving worker ...``: the replica worker
process (``serving/worker.py``) that ``pool.ProcReplica`` spawns
(counterpart of the ``worker`` subcommand of
``mxnet_tpu/serving/__main__.py``). The reference's other subcommands
(``bench``, ``warm``) wait for ROADMAP Queue 1 item 13's tooling."""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mxnet_tpu_torch.serving")
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("worker", help="replica worker process behind a "
                                      "loopback socket (serving/pool.py "
                                      "spawns these)")
    from .worker import add_worker_args, cmd_worker
    add_worker_args(w)
    w.set_defaults(fn=cmd_worker)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
