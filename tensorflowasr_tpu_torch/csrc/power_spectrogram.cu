// Framed, windowed-DFT power spectrogram for Hopper (sm_90a), f32 FMA.
//
// Replaces tensorflowasr_tpu/ops/pallas_frontend.py::power_spectrogram_pallas
// (kernel body _kernel). What it computes, for wav x [B, T] f32:
//
//   power[b, f, k] = (sum_n x[b, f*hop + n - lo] * wr[n, k])^2
//                  + (sum_n x[b, f*hop + n - lo] * wi[n, k])^2
//
// for f < n_frames = ceil(T / hop), k < n_freq = n_fft/2 + 1, with x taken
// as zero outside [0, T): `lo` is the left pad ('same': the TF-style centred
// pad; 'valid': n_fft - 1) and every sample past T is the right pad. wr/wi
// are the Hann-windowed DFT matrices.
//
// The DFT operand is the host-built constant [C * hop_pad, 2, n_freq_pad]
// (C = ceil(n_fft / hop) hop rows, each padded to hop_pad columns; re then
// im; zeros in every padded row and column), so a frame is C consecutive
// hop rows of the padded signal and the n_fft-deep dot product becomes C
// shifted, aligned passes over hop rows -- the Pallas kernel's
// factorisation, without its hop padding to the TPU lane width.
//
// Bound: the function needs the wav read once and the power written once,
// 4 * (B*T + B*n_frames*n_freq) bytes; its least arithmetic is a real FFT
// per frame (~2.5 n_fft log2 n_fft FLOP). At the serving shape (B = 128,
// 7 s, n_fft 1024, hop 160) that is ~241 MB, ~72 us at 3.35 TB/s, against
// ~2.5e9 FLOP, ~38 us at 67 TFLOP/s: bound by bytes. This DFT-as-GEMM form
// does 2 * B * n_frames * n_fft * 2 * n_freq = 1.88e11 FLOP, ~2.8 ms at the
// H100's f32 (non-tensor) rate: its design target, not the function's
// bound. It stays on f32 FMA (no TF32) so the power holds rtol 2e-4 against
// the f32 reference.
//
// Design:
// - One block per (64-bin tile, 128-frame tile, batch row). The block reads
//   its slab of 128 + C - 1 hop rows from the unpadded wav ONCE into shared
//   memory (zeros written for the virtual pads); no [B, F, n_fft] frames
//   tensor is ever written, and the wav is not copied to pad it.
// - The DFT operand streams through shared memory in 32-deep tiles
//   (re and im columns of the block's 64 bins).
// - 256 threads, each accumulating 8 frames x 4 bins of re and im in
//   registers (64 accumulators). The A operand is read straight from the
//   slab with float4 loads (frames of one quarter-warp share an address, so
//   they broadcast); the B operand with float4 loads across the bins.
// - The epilogue writes re^2 + im^2 straight to [B, n_frames, n_freq],
//   masking the ragged frame tile and the odd 513th bin.
// Not yet: wgmma/TMA, 3xTF32, double-buffered DFT tiles (a later change).

#include <cuda_runtime.h>

namespace {

constexpr int kBlockFrames = 128;  // BM
constexpr int kBlockBins = 64;     // BN (each bin has a re and an im column)
constexpr int kBlockK = 32;        // BK, divides hop_pad
constexpr int kThreadFrames = 8;   // TM
constexpr int kThreadBins = 4;     // TN
constexpr int kThreads = 256;      // 16 (bins) x 16 (frames)

static_assert(kBlockBins / kThreadBins == 16, "tx spans 16 threads");
static_assert(kBlockFrames / kThreadFrames == 16, "ty spans 16 threads");
static_assert(kBlockK % 4 == 0, "A is read 4 columns at a time");

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

__global__ void __launch_bounds__(kThreads, 2)
power_spectrogram_kernel(const float* __restrict__ wav,
                         const float* __restrict__ dft,
                         float* __restrict__ out,
                         int T, int hop, int hop_pad, int n_chunks, int lo,
                         int n_frames, int n_freq, int n_freq_pad) {
  extern __shared__ float4 smem4[];
  float* slab = reinterpret_cast<float*>(smem4);
  const int slab_rows = kBlockFrames + n_chunks - 1;
  // hop_pad is a multiple of kBlockK, so bs stays 16-byte aligned
  float* bs = slab + slab_rows * hop_pad;  // [kBlockK][2][kBlockBins]

  const int bin0 = blockIdx.x * kBlockBins;
  const int f0 = blockIdx.y * kBlockFrames;
  const int b = blockIdx.z;
  const float* x = wav + static_cast<size_t>(b) * T;

  // slab[r, c] = x[(f0 + r) * hop + c - lo]; zero for c >= hop or outside
  // [0, T) -- the 'same'/'valid' pads are virtual
  for (int i = threadIdx.x; i < slab_rows * hop_pad; i += kThreads) {
    const int r = i / hop_pad;
    const int c = i - r * hop_pad;
    const long long s = static_cast<long long>(f0 + r) * hop + c - lo;
    slab[i] = (c < hop && s >= 0 && s < T) ? __ldg(x + s) : 0.f;
  }

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc_re[kThreadFrames][kThreadBins];
  float acc_im[kThreadFrames][kThreadBins];
#pragma unroll
  for (int i = 0; i < kThreadFrames; ++i) {
#pragma unroll
    for (int j = 0; j < kThreadBins; ++j) {
      acc_re[i][j] = 0.f;
      acc_im[i][j] = 0.f;
    }
  }

  const size_t dft_row = 2 * static_cast<size_t>(n_freq_pad);
  const float4* bs4 = reinterpret_cast<const float4*>(bs);
  constexpr int kRow4 = 2 * kBlockBins / 4;  // float4s per B-tile row

  for (int r = 0; r < n_chunks; ++r) {
    for (int c0 = 0; c0 < hop_pad; c0 += kBlockK) {
      const int k0 = r * hop_pad + c0;
      __syncthreads();  // slab staged / previous B tile consumed
      for (int i = threadIdx.x; i < kBlockK * kRow4; i += kThreads) {
        const int row = i / kRow4;
        const int col4 = i - row * kRow4;
        const int part = col4 / (kBlockBins / 4);  // 0 = re, 1 = im
        const int j4 = col4 - part * (kBlockBins / 4);
        const float* src = dft + (k0 + row) * dft_row +
                           static_cast<size_t>(part) * n_freq_pad + bin0 +
                           4 * j4;
        reinterpret_cast<float4*>(bs)[i] =
            __ldg(reinterpret_cast<const float4*>(src));
      }
      __syncthreads();

      const float* a_base = slab + (ty * kThreadFrames + r) * hop_pad + c0;
#pragma unroll
      for (int kk = 0; kk < kBlockK; kk += 4) {
        float4 a[kThreadFrames];
#pragma unroll
        for (int i = 0; i < kThreadFrames; ++i) {
          a[i] = *reinterpret_cast<const float4*>(a_base + i * hop_pad + kk);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 br = bs4[(kk + q) * kRow4 + tx];
          const float4 bi = bs4[(kk + q) * kRow4 + kBlockBins / 4 + tx];
#pragma unroll
          for (int i = 0; i < kThreadFrames; ++i) {
            const float av = lane(a[i], q);
            acc_re[i][0] = fmaf(av, br.x, acc_re[i][0]);
            acc_re[i][1] = fmaf(av, br.y, acc_re[i][1]);
            acc_re[i][2] = fmaf(av, br.z, acc_re[i][2]);
            acc_re[i][3] = fmaf(av, br.w, acc_re[i][3]);
            acc_im[i][0] = fmaf(av, bi.x, acc_im[i][0]);
            acc_im[i][1] = fmaf(av, bi.y, acc_im[i][1]);
            acc_im[i][2] = fmaf(av, bi.z, acc_im[i][2]);
            acc_im[i][3] = fmaf(av, bi.w, acc_im[i][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kThreadFrames; ++i) {
    const int f = f0 + ty * kThreadFrames + i;
    if (f >= n_frames) continue;
    float* row = out + (static_cast<size_t>(b) * n_frames + f) * n_freq;
#pragma unroll
    for (int j = 0; j < kThreadBins; ++j) {
      const int k = bin0 + tx * kThreadBins + j;
      if (k < n_freq) {
        row[k] = acc_re[i][j] * acc_re[i][j] + acc_im[i][j] * acc_im[i][j];
      }
    }
  }
}

}  // namespace

extern "C" {

// Tile sizes the host must pad the DFT operand to.
int tasr_power_spectrogram_block_bins() { return kBlockBins; }
int tasr_power_spectrogram_block_k() { return kBlockK; }

// Shared memory one block needs, in bytes.
long long tasr_power_spectrogram_smem_bytes(int hop_pad, int n_chunks) {
  return (static_cast<long long>(kBlockFrames + n_chunks - 1) * hop_pad +
          kBlockK * 2 * kBlockBins) *
         static_cast<long long>(sizeof(float));
}

// Launches on `stream`; returns cudaGetLastError() of the launch (0 = ok).
int tasr_power_spectrogram(const float* wav, const float* dft, float* out,
                           int batch, int T, int hop, int hop_pad,
                           int n_chunks, int lo, int n_frames, int n_freq,
                           int n_freq_pad, void* stream) {
  if (batch <= 0 || T <= 0 || n_frames <= 0 || hop <= 0 ||
      hop_pad % kBlockK != 0 || hop_pad < hop || n_freq_pad % kBlockBins ||
      n_freq_pad < n_freq || n_chunks <= 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = tasr_power_spectrogram_smem_bytes(hop_pad, n_chunks);
  cudaError_t err = cudaFuncSetAttribute(
      power_spectrogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_freq_pad / kBlockBins,
                  (n_frames + kBlockFrames - 1) / kBlockFrames, batch);
  power_spectrogram_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                             static_cast<cudaStream_t>(stream)>>>(
      wav, dft, out, T, hop, hop_pad, n_chunks, lo, n_frames, n_freq,
      n_freq_pad);
  return static_cast<int>(cudaGetLastError());
}

const char* tasr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
