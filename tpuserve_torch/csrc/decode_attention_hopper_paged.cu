// The Hopper decode-attention core: the paged form at head_dim 128 (the
// kernel template of attention_core.cuh), reached through the C entry in
// decode_attention_hopper.cu. A translation unit of its own, so that nvcc
// builds the core's instances at once.
#include "attention_core.cuh"

template int tpuserve::core::launch_kind<true, false, 128>(const tpuserve::core::Args&, int,
                                                           int, cudaStream_t);
