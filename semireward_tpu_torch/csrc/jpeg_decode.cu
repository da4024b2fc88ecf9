// JPEG decode on the card through nvJPEG (the CUDA toolkit's decoder), for
// the JPEG-folder datasets (semireward_tpu_torch/data/cv_extra.py).
//
// Replaces no TPU kernel: the JAX package decodes on the host
// (semireward_tpu/data/cv_extra.py:JPEGFolderDataset.gather, PIL or the
// libjpeg-turbo helper data/_native/fastbatch.cpp). The card's machine has
// no libjpeg, and a host decode of ~512 full-size images a ViT-B/16 step is
// the JAX package's own measured bottleneck, so the port decodes here: the
// host reads the file and nvJPEG's default (hybrid) backend parses and
// Huffman-decodes it on the calling thread, then runs the inverse DCT, the
// chroma upsampling and the colour conversion on the given stream. The
// resize to the dataset's square size runs after it in PyTorch
// (data/_nvjpeg.py).
//
// Bound: a decode moves the compressed bytes in and h*w*3 bytes out (a few
// microseconds of HBM time a 500 x 375 image); its floor is the host's
// Huffman decode, one image at a time on each calling thread. The data
// loader calls this from a pool of host threads, each with its own
// nvjpegJpegState (a handle is shared; a state is not thread-safe).
//
// The C interface returns nvJPEG's status (0 = success; 3 = bad JPEG and 4 =
// not supported are files nvJPEG rejects, which the caller decodes on the
// host), or kCudaError + the CUDA error after a failed launch.
#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>

namespace {
constexpr int kCudaError = 1000;
}

extern "C" {

// nvJPEG's version, major * 1000 + minor * 10 + patch (as CUDA numbers).
int srt_jpeg_version() {
  int major = 0, minor = 0, patch = 0;
  if (nvjpegGetProperty(MAJOR_VERSION, &major) != NVJPEG_STATUS_SUCCESS ||
      nvjpegGetProperty(MINOR_VERSION, &minor) != NVJPEG_STATUS_SUCCESS ||
      nvjpegGetProperty(PATCH_LEVEL, &patch) != NVJPEG_STATUS_SUCCESS)
    return -1;
  return major * 1000 + minor * 10 + patch;
}

int srt_jpeg_handle_create(void** handle) {
  return (int)nvjpegCreateSimple(reinterpret_cast<nvjpegHandle_t*>(handle));
}

int srt_jpeg_handle_destroy(void* handle) {
  return (int)nvjpegDestroy(static_cast<nvjpegHandle_t>(handle));
}

int srt_jpeg_state_create(void* handle, void** state) {
  return (int)nvjpegJpegStateCreate(static_cast<nvjpegHandle_t>(handle),
                                    reinterpret_cast<nvjpegJpegState_t*>(state));
}

int srt_jpeg_state_destroy(void* state) {
  return (int)nvjpegJpegStateDestroy(static_cast<nvjpegJpegState_t>(state));
}

// The file's components, size and chroma subsampling (nvjpegChromaSubsampling_t).
int srt_jpeg_info(void* handle, const unsigned char* data, size_t length,
                  int* components, int* width, int* height, int* subsampling) {
  int widths[NVJPEG_MAX_COMPONENT] = {0}, heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_UNKNOWN;
  nvjpegStatus_t s = nvjpegGetImageInfo(static_cast<nvjpegHandle_t>(handle), data, length,
                                        components, &css, widths, heights);
  *width = widths[0];
  *height = heights[0];
  *subsampling = (int)css;
  return (int)s;
}

// Decode into device memory at out: interleaved RGB rows of pitch bytes
// (gray = 0) or, for a one-component file (gray = 1), its Y plane. The
// caller sized out from srt_jpeg_info.
int srt_jpeg_decode(void* handle, void* state, const unsigned char* data, size_t length,
                    int gray, void* out, int pitch, void* stream) {
  nvjpegImage_t img = {};
  img.channel[0] = static_cast<unsigned char*>(out);
  img.pitch[0] = (unsigned int)pitch;
  nvjpegStatus_t s = nvjpegDecode(static_cast<nvjpegHandle_t>(handle),
                                  static_cast<nvjpegJpegState_t>(state), data, length,
                                  gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI, &img,
                                  static_cast<cudaStream_t>(stream));
  if (s != NVJPEG_STATUS_SUCCESS) return (int)s;
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : kCudaError + (int)e;
}

}  // extern "C"
