// The Hopper decode-attention core: the flat and multi-candidate forms at head_dim
// 256, skipping the blocks past a slot's last row (the kernel template of
// attention_core.cuh), reached through the C entry in
// decode_attention_hopper.cu. A translation unit of its own, so that nvcc
// builds the core's instances at once.
#include "attention_core.cuh"

template int tpuserve::core::launch_kind<false, false, 256>(const tpuserve::core::Args&, int,
                                                            int, cudaStream_t);
