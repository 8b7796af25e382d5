// Device buffers that the ranks of one world share when they share a card
// (models/collectives.py): each rank cudaMallocs its own outside the
// framework's caching allocator, so that the mapping lives as long as the
// world whatever the allocator's settings, and opens every other rank's
// from its cudaIpcMemHandle_t. No kernel here: the collectives copy and
// add with the framework's ops.
#include <cuda_runtime.h>

#include <cstring>

extern "C" int rt_ipc_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

// A buffer of `bytes` on `device` and its IPC handle (rt_ipc_handle_bytes()
// bytes written to `handle`).
extern "C" int rt_ipc_alloc(int device, size_t bytes, void** ptr,
                            void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
    return static_cast<int>(err);
  }
  std::memcpy(handle, &h, sizeof(h));
  return 0;
}

// Another process's buffer, mapped into this one.
extern "C" int rt_ipc_open(int device, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int rt_ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

extern "C" int rt_ipc_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}
