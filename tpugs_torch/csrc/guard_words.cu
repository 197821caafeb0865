// Guard words of the kernels that check their inputs' contract on the
// device (align_copy.cu, segreduce.cu's interval sum): one int32 per kernel,
// in the order of cuda_lib.GUARDED, in mapped, portable pinned host memory,
// zeroed, allocated once per process. A kernel stores into its word through
// the device address; cuda_lib.check_guards reads it through the host
// address, which does not synchronise the device.
#include <cuda_runtime.h>

// `count` words: the caller's number of guarded kernels. A later call must
// ask for the same count, so no caller can index past the allocation.
extern "C" int tpugs_guard_words(int count, void** host, void** device) {
  static int* words = nullptr;
  static void* dev_words = nullptr;
  static int allocated = 0;
  if (words == nullptr) {
    if (count <= 0) return (int)cudaErrorInvalidValue;
    int* h = nullptr;
    cudaError_t err = cudaHostAlloc((void**)&h, count * sizeof(int),
                                    cudaHostAllocMapped | cudaHostAllocPortable);
    if (err != cudaSuccess) return (int)err;
    for (int i = 0; i < count; ++i) h[i] = 0;
    err = cudaHostGetDevicePointer(&dev_words, h, 0);
    if (err != cudaSuccess) {
      cudaFreeHost(h);
      return (int)err;
    }
    words = h;
    allocated = count;
  } else if (count != allocated) {
    return (int)cudaErrorInvalidValue;
  }
  *host = words;
  *device = dev_words;
  return 0;
}
