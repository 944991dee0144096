// Helpers shared by the kernel sources, defined in common.cu.
#pragma once
#include <cuda_runtime.h>

// The current device's SM count, asked of the device once and cached.
// Grids and tile choices are sized from it, not from a constant.
cudaError_t windve_sm_count(int* n);
