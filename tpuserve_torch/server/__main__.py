"""CLI entry point: `python -m tpuserve_torch.server --repository models --port 8080`
(PyTorch port of tpuserve/server/__main__.py).

The reference server has no CLI flags at all (SURVEY.md §5 config); here the
basics are flags with env-var fallbacks. Models load on the card unless
`--platform cpu` asks for the CPU; without a card, the server still answers
and a load fails with the engine's no-card error.

Multi-process serving: every rank runs this same entry point with the same
repository and TPUSERVE_COORDINATOR (host:port of process 0),
TPUSERVE_NUM_PROCESSES and TPUSERVE_PROCESS_ID. Process 0 serves the
fronts; the others replay its steps (server/follower.py) until it exits.
The sharded model's mesh must match the number of processes.
"""

import argparse
import os
import sys

_PLATFORMS = {"": "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def _platform(value: str) -> str:
    """--platform / TPUSERVE_PLATFORM -> the torch device type models load on."""
    key = value.strip().lower()
    if key not in _PLATFORMS:
        raise argparse.ArgumentTypeError(
            f"unknown platform {value!r}: use gpu, cuda or cpu")
    return _PLATFORMS[key]


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpuserve_torch",
                                description="quantized inference server (PyTorch/CUDA)")
    p.add_argument(
        "--repository",
        default=os.environ.get("TPUSERVE_REPOSITORY", "./models"),
        help="model repository path (default ./models)",
    )
    p.add_argument("--host", default=os.environ.get("TPUSERVE_HOST", "0.0.0.0"))
    p.add_argument("--port", type=int, default=int(os.environ.get("TPUSERVE_PORT", "8080")))
    p.add_argument(
        "--grpc-port",
        type=int,
        default=int(os.environ.get("TPUSERVE_GRPC_PORT", "0")),
        help="also serve gRPC on this port (0 = disabled)",
    )
    p.add_argument(
        "--platform",
        type=_platform,
        default=os.environ.get("TPUSERVE_PLATFORM", ""),
        help="device models load on: gpu or cuda (the default: the card), or cpu",
    )
    args = p.parse_args(argv)

    multihost = False
    if os.environ.get("TPUSERVE_COORDINATOR"):
        from tpuserve_torch.parallel import distributed
        from tpuserve_torch.utils.errors import BackendError

        try:
            distributed.initialize(device_type=args.platform)
        except BackendError as e:
            sys.exit(f"multi-process serving: {e}")
        multihost = distributed.is_multi_host()
        if multihost and distributed.process_info()["process_index"] != 0:
            import logging

            from tpuserve_torch.server.follower import run_follower_server

            logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                                format="%(asctime)s follower %(levelname)s %(message)s")

            try:
                run_follower_server()
            finally:
                distributed.shutdown()
            return

    from aiohttp import web

    from tpuserve_torch.engine.manager import InferenceManager
    from tpuserve_torch.server.http import create_app

    # one manager shared by both frontends
    manager = InferenceManager(args.repository, device=args.platform)
    grpc_server = None
    try:
        if args.grpc_port:
            from tpuserve_torch.server.grpc import create_grpc_server

            grpc_server = create_grpc_server(manager, args.grpc_port, args.host)
            grpc_server.start()
        app = create_app(args.repository, manager=manager)
        web.run_app(app, host=args.host, port=args.port, shutdown_timeout=5.0, print=None)
    finally:
        if grpc_server is not None:
            grpc_server.stop(grace=5.0)
        manager.shutdown()
        if multihost:
            # release the follower processes blocked in their event loop
            from tpuserve_torch.parallel import distributed
            from tpuserve_torch.parallel.dispatcher import publish_event

            try:
                publish_event(("shutdown",))
            finally:
                distributed.shutdown()


if __name__ == "__main__":
    main()
