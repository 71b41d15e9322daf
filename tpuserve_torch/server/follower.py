"""Follower ranks of sharded serving (PyTorch port of tpuserve/server/follower.py).

Every rank runs the same repository and weights (the same checkpoint files,
or the same seeded init). Process 0, the controller, serves REST/gRPC as on
one host; every other process lands here and replays the controller's
events: a ("load", model_dir, config, device type) event builds and starts
the same engine on this rank's card, whose `run_follower` replays the
model's steps until it unloads. Two ways in:

- `python -m tpuserve_torch.server` with TPUSERVE_COORDINATOR /
  TPUSERVE_NUM_PROCESSES / TPUSERVE_PROCESS_ID set: processes > 0 run
  `run_follower_server` until the controller shuts down;
- `python -m tpuserve_torch.server.follower --once`: a rank a sharded
  engine started on its own host, which serves that one model and exits.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

log = logging.getLogger("tpuserve_torch.follower")


def run_follower_server(once: bool = False) -> None:
    """Blocking loop: build and drive engines as the controller loads and
    unloads models, until a ("shutdown",) event (or, `once`, the first
    model's unload)."""
    from tpuserve_torch.parallel import distributed
    from tpuserve_torch.parallel.dispatcher import exchange, recv_event
    from tpuserve_torch.serving.engine import GenerationEngine

    info = distributed.process_info()
    log.info("follower %d/%d up (%s)", info["process_index"], info["process_count"],
             info["backend"])
    while True:
        ev = recv_event()
        op = ev[0]
        if op == "ping":
            continue
        if op == "shutdown":
            return
        if op == "stats":   # no model here: answer with an empty record
            exchange({"rank": info["process_index"]})
            continue
        if op != "load":
            raise RuntimeError(f"follower expected a load or shutdown event, got {op!r}")
        _, model_dir, config, device_type = ev
        log.info("follower loading %s", model_dir)
        engine = GenerationEngine(model_dir, config, device=device_type)
        engine.start()
        try:
            last = engine.run_follower()
        finally:
            engine.stop()
        log.info("follower unloaded %s", model_dir)
        if once or last == "shutdown":
            return


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpuserve_torch.server.follower",
                                description="a follower rank of sharded serving")
    p.add_argument("--once", action="store_true",
                   help="serve one model, then exit (a rank an engine started)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s follower %(levelname)s %(message)s")
    from tpuserve_torch.parallel import distributed
    from tpuserve_torch.server.__main__ import _platform

    if not distributed.initialize(
            device_type=_platform(os.environ.get("TPUSERVE_PLATFORM", ""))):
        sys.exit("a follower needs TPUSERVE_COORDINATOR, TPUSERVE_NUM_PROCESSES and "
                 "TPUSERVE_PROCESS_ID")
    try:
        run_follower_server(once=args.once)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
