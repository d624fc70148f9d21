// What every kernel file of the library shares at the C interface: the text
// of a CUDA error code, for the Python wrappers that raise on a failed launch
// (ops/cuda_build.py::check).
#include <cuda_runtime.h>

extern "C" const char* kernels_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
