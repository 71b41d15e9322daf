from tpuserve_torch.server.http import create_app, run_server  # noqa: F401
