// Framed, Hann-windowed power spectrogram for Hopper (sm_90a): one real FFT
// per frame, held in registers and shared memory.
//
// Replaces tensorflowasr_tpu/ops/pallas_frontend.py::power_spectrogram_pallas
// (kernel body _kernel). What it computes, for wav x [B, T] f32:
//
//   power[b, f, k] = | sum_n w[n] x[b, f*hop + n - lo] e^{-2 pi i n k / N} |^2
//
// for f < n_frames = ceil(T / hop), k <= N/2, N = n_fft = 1024, with x taken
// as zero outside [0, T): `lo` is the left pad ('same': the TF-style centred
// pad; 'valid': N - 1) and every sample past T is the right pad. w is the
// periodic Hann window.
//
// Bound: bytes. The function needs the wav read once and the power written
// once, 4 * (B*T + B*n_frames*513) bytes; at the serving shape (B = 128,
// 7 s, hop 160) that is 2.41e8 B, 0.072 ms at 3.35 TB/s, against 2.5e9 FLOP
// of real FFTs, 0.038 ms at 67 TFLOP/s. The TPU kernel did the DFT as a
// matrix product (75x the FLOP) because the MXU is that chip's fast unit;
// here products are cheap and bytes are scarce, so the frame is transformed
// by an FFT and nothing but the wav and the power touches device memory.
//
// Design:
// - One block owns `tile_frames` consecutive frames of one batch row. It
//   stages their slab of (tile_frames - 1) * hop + N samples into shared
//   memory once with cp.async (the frames overlap N / hop = 6.4-fold, so
//   every frame then reads shared memory) and writes zeros for the virtual
//   pads: no padded copy of the wav and no frames tensor exist. The copies
//   are 16 bytes wide where the host found every slab start and the row
//   stride 16-byte aligned, else 4 bytes wide.
// - 64 threads transform one frame; blockDim.x / 64 frames are in flight.
//   The N real samples, times the window, are packed as M = N/2 = 512
//   complex values z[m] = xw[2m] + i xw[2m+1]. A 512-point complex FFT runs
//   as three radix-8 passes (decimation in frequency), 8 complex values a
//   thread in registers, with two exchanges through shared memory:
//     pass 1: thread t   reads z[t + 64 j],            j  -> k1, times W512^(t k1)
//     pass 2: thread u   reads y[k1][t2 + 8 j2],       j2 -> k2, times W64^(t2 k2)
//             (k1 = u >> 3, t2 = u & 7)
//     pass 3: thread v   reads y2[k1][k2][t2],         t2 -> k3
//             (k1 = v & 7, k2 = v >> 3), Z[k1 + 8 k2 + 64 k3] = Z[v + 64 k3]
//   The exchange rows are padded (strides 72 and 66 float2) so that every
//   8-byte shared-memory access of a half-warp falls in distinct banks.
// - Untangle: with A = Z[k] + conj Z[M-k], D = Z[k] - conj Z[M-k] and
//   u[k] = -i e^{-2 pi i k / N}, X[k] = (A + u D) / 2 and
//   X[M-k] = conj(A - u D) / 2, so one pair gives two bins. Thread t takes
//   k = t + 64 i (i < 4) and writes bins k and 512 - k; neighbouring threads
//   write neighbouring 4-byte bins of the frame's 513-float row (rows are
//   not 16-byte aligned), each exactly once.
// - Window, twiddles and untangle factors come from one host-built f32 table
//   (float64 in numpy, rounded once); each thread keeps its own entries in
//   registers across its frames. No fast-math intrinsics.
// - The two exchange buffers of a frame swap roles each iteration, so three
//   block-wide barriers a frame suffice.

#include <cuda_runtime.h>

namespace {

constexpr int kNfft = 1024;
constexpr int kHalf = kNfft / 2;       // M: points of the complex FFT
constexpr int kFrameThreads = 64;      // threads that transform one frame
constexpr int kMaxGroups = 4;          // frames in flight per block
constexpr int kEx1Stride = 72;         // float2 row stride of exchange 1
constexpr int kEx2Stride = 66;         // float2 row stride of exchange 2
constexpr int kBufFloat2 = 8 * kEx1Stride;  // one exchange buffer (>= 512)
constexpr long long kMaxSmemBytes = 232448;  // per block on sm_90 (227 KB)

// float offsets into the host-built table
constexpr int kWinOff = 0;                     // window [N]
constexpr int kTw1Off = kWinOff + kNfft;       // W512^(t k1)  [8][64] float2
constexpr int kTw2Off = kTw1Off + 2 * kHalf;   // W64^(t2 k2)  [8][8] float2
constexpr int kUtOff = kTw2Off + 2 * 64;       // u[k], k <= 256: float2
constexpr int kTableFloats = kUtOff + 2 * (kHalf / 2 + 1);

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * (-i)
__device__ __forceinline__ float2 mul_neg_i(float2 a) {
  return make_float2(a.y, -a.x);
}

// 4-point forward DFT of (c0, c1, c2, c3) -> (y0, y1, y2, y3)
__device__ __forceinline__ void fft4(float2 c0, float2 c1, float2 c2,
                                     float2 c3, float2& y0, float2& y1,
                                     float2& y2, float2& y3) {
  const float2 d0 = cadd(c0, c2);
  const float2 d1 = csub(c0, c2);
  const float2 d2 = cadd(c1, c3);
  const float2 d3 = mul_neg_i(csub(c1, c3));
  y0 = cadd(d0, d2);
  y1 = cadd(d1, d3);
  y2 = csub(d0, d2);
  y3 = csub(d1, d3);
}

// 8-point forward DFT in place, natural order in and out:
// a[k] <- sum_j a[j] e^{-2 pi i j k / 8}
__device__ __forceinline__ void fft8(float2 (&a)[8]) {
  constexpr float h = 0.70710678118654752440f;
  const float2 b0 = cadd(a[0], a[4]);
  const float2 b1 = cadd(a[1], a[5]);
  const float2 b2 = cadd(a[2], a[6]);
  const float2 b3 = cadd(a[3], a[7]);
  const float2 b4 = csub(a[0], a[4]);
  float2 b5 = csub(a[1], a[5]);
  float2 b6 = csub(a[2], a[6]);
  float2 b7 = csub(a[3], a[7]);
  b5 = make_float2(h * (b5.x + b5.y), h * (b5.y - b5.x));    // * W8^1
  b6 = mul_neg_i(b6);                                        // * W8^2
  b7 = make_float2(h * (b7.y - b7.x), -h * (b7.x + b7.y));   // * W8^3
  fft4(b0, b1, b2, b3, a[0], a[2], a[4], a[6]);
  fft4(b4, b5, b6, b7, a[1], a[3], a[5], a[7]);
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float norm2(float2 a) {
  return a.x * a.x + a.y * a.y;
}

__global__ void __launch_bounds__(kMaxGroups * kFrameThreads, 3)
power_spectrogram_kernel(const float* __restrict__ wav,
                         const float* __restrict__ tables,
                         float* __restrict__ out, int T, int hop, int lo,
                         int n_frames, int tile_frames, int tiles, int vec16) {
  extern __shared__ float4 smem4[];
  float* slab = reinterpret_cast<float*>(smem4);
  const int slab_len = (tile_frames - 1) * hop + kNfft;
  const int slab_pad = (slab_len + 3) & ~3;
  float2* bufs = reinterpret_cast<float2*>(slab + slab_pad);

  const int tid = threadIdx.x;
  const int t = tid & (kFrameThreads - 1);
  const int g = tid / kFrameThreads;
  const int groups = blockDim.x / kFrameThreads;
  const int tile = blockIdx.x % tiles;
  const int b = blockIdx.x / tiles;
  const int f0 = tile * tile_frames;
  const long long s0 = static_cast<long long>(f0) * hop - lo;
  const float* x = wav + static_cast<size_t>(b) * T;

  // slab[i] = x[s0 + i], zero outside [0, T): the pads are virtual
  if (vec16) {
    // s0, T and the row stride are multiples of 4 samples, so a 16-byte
    // chunk lies wholly inside or wholly outside the row
    float4* slab4 = reinterpret_cast<float4*>(slab);
    for (int c = tid; c < slab_pad / 4; c += blockDim.x) {
      const long long s = s0 + 4 * c;
      if (s >= 0 && s + 4 <= T) {
        cp_async_16(slab4 + c, x + s);
      } else {
        slab4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int i = tid; i < slab_len; i += blockDim.x) {
      const long long s = s0 + i;
      if (s >= 0 && s < T) {
        cp_async_4(slab + i, x + s);
      } else {
        slab[i] = 0.f;
      }
    }
  }

  // this thread's table entries, kept across its frames
  const float2* win_tab = reinterpret_cast<const float2*>(tables + kWinOff);
  const float2* tw1_tab = reinterpret_cast<const float2*>(tables + kTw1Off);
  const float2* tw2_tab = reinterpret_cast<const float2*>(tables + kTw2Off);
  const float2* ut_tab = reinterpret_cast<const float2*>(tables + kUtOff);
  const int k1b = t >> 3;  // pass 2: sub-transform
  const int t2 = t & 7;    // pass 2: residue
  float2 win[8], tw1[8], tw2[8], ut[5];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    win[j] = __ldg(win_tab + t + kFrameThreads * j);
    tw1[j] = __ldg(tw1_tab + kFrameThreads * j + t);
    tw2[j] = __ldg(tw2_tab + 8 * j + t2);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) ut[i] = __ldg(ut_tab + t + kFrameThreads * i);
  ut[4] = __ldg(ut_tab + kHalf / 2);

  cp_async_wait_all();
  __syncthreads();

  float2* buf_a = bufs + (2 * g) * kBufFloat2;
  float2* buf_b = buf_a + kBufFloat2;
  const bool hop_even = (hop & 1) == 0;

  // tile_frames is a multiple of groups, so every thread meets every barrier
  for (int fl = g; fl < tile_frames; fl += groups) {
    const float* frame = slab + fl * hop;
    float2 a[8];
    if (hop_even) {
      const float2* frame2 = reinterpret_cast<const float2*>(frame);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 v = frame2[t + kFrameThreads * j];
        a[j] = make_float2(v.x * win[j].x, v.y * win[j].y);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = t + kFrameThreads * j;
        a[j] = make_float2(frame[2 * m] * win[j].x,
                           frame[2 * m + 1] * win[j].y);
      }
    }

    // pass 1: over j, m = t + 64 j
    fft8(a);
    buf_a[t] = a[0];
#pragma unroll
    for (int k1 = 1; k1 < 8; ++k1) {
      buf_a[k1 * kEx1Stride + t] = cmul(a[k1], tw1[k1]);
    }
    __syncthreads();

    // pass 2: over j2, t = t2 + 8 j2, for sub-transform k1b
#pragma unroll
    for (int j2 = 0; j2 < 8; ++j2) {
      a[j2] = buf_a[k1b * kEx1Stride + t2 + 8 * j2];
    }
    fft8(a);
    buf_b[t2 * kEx2Stride + k1b] = a[0];
#pragma unroll
    for (int k2 = 1; k2 < 8; ++k2) {
      buf_b[t2 * kEx2Stride + 8 * k2 + k1b] = cmul(a[k2], tw2[k2]);
    }
    __syncthreads();

    // pass 3: over t2, for (k1, k2) = (t & 7, t >> 3); Z[t + 64 k3]
#pragma unroll
    for (int r = 0; r < 8; ++r) a[r] = buf_b[r * kEx2Stride + t];
    fft8(a);
#pragma unroll
    for (int k3 = 0; k3 < 8; ++k3) buf_a[t + kFrameThreads * k3] = a[k3];
    __syncthreads();

    // untangle the real transform and square
    const int f = f0 + fl;
    if (f < n_frames) {
      float* row = out + (static_cast<size_t>(b) * n_frames + f) *
                             (kHalf + 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = t + kFrameThreads * i;
        const float2 zk = buf_a[k];
        const float2 zr = buf_a[(kHalf - k) & (kHalf - 1)];
        const float2 sum = make_float2(zk.x + zr.x, zk.y - zr.y);
        const float2 dif = make_float2(zk.x - zr.x, zk.y + zr.y);
        const float2 rot = cmul(ut[i], dif);
        row[k] = 0.25f * norm2(cadd(sum, rot));
        row[kHalf - k] = 0.25f * norm2(csub(sum, rot));
      }
      if (t == 0) {
        const float2 z = buf_a[kHalf / 2];
        const float2 sum = make_float2(2.f * z.x, 0.f);
        const float2 dif = make_float2(0.f, 2.f * z.y);
        row[kHalf / 2] = 0.25f * norm2(cadd(sum, cmul(ut[4], dif)));
      }
    }
    // the next frame's exchange 1 goes where this frame's exchange 2 was:
    // every thread read that before the last barrier
    float2* swap = buf_a;
    buf_a = buf_b;
    buf_b = swap;
  }
}

}  // namespace

extern "C" {

// What the host must build the table for and how long it is.
int tasr_power_spectrogram_n_fft() { return kNfft; }
int tasr_power_spectrogram_table_floats() { return kTableFloats; }

// Shared memory one block needs, in bytes: the slab, then two exchange
// buffers for each frame in flight.
long long tasr_power_spectrogram_smem_bytes(int hop, int tile_frames,
                                            int groups) {
  const long long slab_len =
      static_cast<long long>(tile_frames - 1) * hop + kNfft;
  const long long slab_pad = (slab_len + 3) & ~3LL;
  return slab_pad * static_cast<long long>(sizeof(float)) +
         static_cast<long long>(groups) * 2 * kBufFloat2 *
             static_cast<long long>(sizeof(float2));
}

// Launches on `stream`: blocks of `groups` x 64 threads, each over
// `tile_frames` frames (a multiple of `groups`) of one batch row. `vec16`
// selects 16-byte slab copies: the caller guarantees that wav, T, lo and
// tile_frames * hop are all multiples of 16 bytes / 4 samples. Returns
// cudaGetLastError() of the launch (0 = ok).
int tasr_power_spectrogram(const float* wav, const float* tables, float* out,
                           int batch, int T, int hop, int lo, int n_frames,
                           int tile_frames, int groups, int vec16,
                           void* stream) {
  if (batch <= 0 || T <= 0 || n_frames <= 0 || hop <= 0 || lo < 0 ||
      groups <= 0 || groups > kMaxGroups || tile_frames <= 0 ||
      tile_frames % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (n_frames + tile_frames - 1) / tile_frames;
  if (tiles * batch > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem =
      tasr_power_spectrogram_smem_bytes(hop, tile_frames, groups);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      power_spectrogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  power_spectrogram_kernel<<<static_cast<unsigned>(tiles * batch),
                             groups * kFrameThreads,
                             static_cast<size_t>(smem),
                             static_cast<cudaStream_t>(stream)>>>(
      wav, tables, out, T, hop, lo, n_frames, tile_frames,
      static_cast<int>(tiles), vec16);
  return static_cast<int>(cudaGetLastError());
}

const char* tasr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
