from tpuserve_torch.device.info import (  # noqa: F401
    DeviceInfo,
    MemoryInfo,
    all_device_infos,
    all_memory_infos,
    get_device_count,
    get_device_info,
    get_memory_info,
    is_gpu_available,
    platform_name,
)
from tpuserve_torch.device.smoke import run_smoke_test, vector_add  # noqa: F401
