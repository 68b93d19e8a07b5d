// Constants shared by the band attention kernels (band_attention.cu,
// band_attention_short.cu) and the whole-A2C2f kernels (a2c2f_f32.cu,
// a2c2f_bf16.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace yolou {

// The default width of the head-wide layouts (YOLOv12's heads are 32
// wide); every kernel also takes 64 (`kv_at<64>`, the HD_ template
// arguments).
constexpr int HD = 32;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace yolou
