// Constants shared by the band attention kernels (band_attention.cu) and the
// whole-A2C2f kernels (a2c2f_f32.cu, a2c2f_bf16.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace yolou {

// Head width of the resident bf16 path and the default of the head-wide
// layouts (YOLOv12's heads are 32 wide); the streamed kernels and the
// a2c2f kernels also take 64 (`kv_at<64>`, the HD_ template arguments).
constexpr int HD = 32;
constexpr int WARPS = 8;      // warps per CTA of the SIMT kernels
constexpr unsigned FULL = 0xffffffffu;

}  // namespace yolou
