#!/usr/bin/env python3
"""What bounds B5 (the beam-selection row statistics) on the GPU: its time
beside the least time a kernel takes to read the same logits, both timed
as chip_smoke.py times B5:

    python3 scripts/b5_read_floor.py

For x (R, 128256) f32 at R 45 (configuration (d)'s 3 x 15 beams), 8, 13
and 480 it prints one line "FLOOR {json}" with, in ms per call:
  - empty: a launch that does nothing (a 16-float fill), the fixed cost of
    `chip_smoke.time_ms`'s events and of one launch;
  - read: a streaming read of x and nothing else (`read_max` below: each
    thread keeps 8 float4 loads in flight, 16 blocks of 256 threads per
    SM, one max per warp written), with a cold L2 as `time_ms` leaves it
    (64 MB zeroed before each call, so the L2 holds dirty lines) and with
    a clean one (64 MB read before each call);
  - b5: `row_stats_chunkmax` under the same two flushes, and with x in L2
    (`warm`: nothing flushed, as in the serving loop, where the lm_head has
    just written the logits).
The read kernel is a yardstick built by this script with nvcc, not a part
of the port.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from omni_avsr_tpu_torch import kernels  # noqa: E402
from omni_avsr_tpu_torch.ops.select_topk import row_stats_chunkmax  # noqa: E402

READ_MAX = r"""
#include <cuda_runtime.h>
#include <math.h>
__global__ void read_max(const float4* __restrict__ x, size_t n4, float* out) {
  float m = -INFINITY;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4; i += 8 * stride) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = i + u * stride < n4 ? __ldcs(x + i + u * stride) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < 8; ++u) m = fmaxf(m, fmaxf(fmaxf(v[u].x, v[u].y), fmaxf(v[u].z, v[u].w)));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) out[blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32] = m;
}
extern "C" int read_max_launch(const void* x, size_t n4, void* out, int blocks, void* stream) {
  read_max<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float4*)x, n4, (float*)out);
  return (int)cudaGetLastError();
}
"""


def build_read_max():
    src = kernels.BUILD_DIR / "read_max.cu"
    lib = kernels.BUILD_DIR / "libread_max.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(READ_MAX)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).read_max_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class CleanFlush:
    """`time_ms`'s flush, by reading 64 MB instead of writing it."""

    def __init__(self):
        self.src = torch.ones(16 << 20, dtype=torch.float32, device="cuda")

    def zero_(self):
        self.src.sum()


def main() -> int:
    if not torch.cuda.is_available():
        print("b5_read_floor: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kernels.build_all(["select_topk"])
    read_max = build_read_max()
    dirty = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")  # time_ms's flush
    clean, none = CleanFlush(), torch.empty(16, dtype=torch.uint8, device="cuda")
    blocks = 16 * kernels.sm_count(torch.device("cuda"))
    out = torch.empty(blocks * 8, device="cuda")
    tiny = torch.empty(16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    for R in (45, 8, 13, 480):
        x = torch.randn(R, 128256, generator=g, device="cuda") * 4

        def read():
            rc = read_max(x.data_ptr(), x.numel() // 4, out.data_ptr(), blocks, stream)
            if rc:
                raise RuntimeError(f"read_max launch failed: CUDA error {rc}")

        read()
        torch.cuda.synchronize()
        if out.max().item() != x.max().item():
            raise RuntimeError("read_max did not read every element")
        b5 = lambda: row_stats_chunkmax(x)  # noqa: E731
        row = dict(R=R, V=128256, mbytes=x.numel() * 4 / 1e6,
                   bound_ms=x.numel() * 4 / cs.HBM_BYTES_PER_S * 1e3,
                   empty_ms=cs.time_ms(lambda: tiny.zero_(), dirty),
                   read_ms=cs.time_ms(read, dirty), read_clean_ms=cs.time_ms(read, clean),
                   b5_ms=cs.time_ms(b5, dirty), b5_clean_ms=cs.time_ms(b5, clean),
                   b5_warm_ms=cs.time_ms(b5, none))
        print("FLOOR " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
