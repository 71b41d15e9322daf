// The grouped decode attention at head_dim 256: every instance of the
// kernel template of attention_grouped.cuh (each window kind, row padding
// and READ_ALL), reached through the C entry in
// decode_attention_grouped_hopper.cu. A translation unit of its own, so
// that nvcc builds both head_dims at once.
#include "attention_grouped.cuh"

template int tpuserve::grouped::launch_kind<256>(const tpuserve::grouped::GArgs&, int, bool,
                                                 cudaStream_t);
