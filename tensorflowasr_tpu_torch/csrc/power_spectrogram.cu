// Framed, Hann-windowed power spectrogram for Hopper (sm_90a): one real FFT
// per frame, held in registers and shared memory, with the log-mel frontend
// fused behind it as a compile-time epilogue.
//
// Replaces tensorflowasr_tpu/ops/pallas_frontend.py::power_spectrogram_pallas
// (K1, kernel body _kernel) and ::log_mel_spectrogram_pallas (K1b: K1, then
// dB, then the mel product). What it computes, for wav x [B, T] f32:
//
//   power[b, f, k] = | sum_n w[n] x[b, f*hop + n - lo] e^{-2 pi i n k / N} |^2
//
// for f < n_frames = ceil(T / hop), k <= N/2, N = n_fft = 1024, with x taken
// as zero outside [0, T): `lo` is the left pad ('same': the TF-style centred
// pad; 'valid': N - 1) and every sample past T is the right pad. w is the
// periodic Hann window. K1b then takes, per bin,
//
//   'valid': db = log10(max(power, 1e-10))
//   'same':  db = max(10 log10(max(power, amin)) - 10 log10(max(P_b, amin)),
//                     -range),  P_b = the largest power of row b
//
// and writes logmel[b, f, m] = sum_k db[b, f, k] W[k, m] for m < n_mels.
//
// Bound: K1's is bytes. K1 needs the wav read once and the power written once,
// 4 * (B*T + B*n_frames*513) bytes; at the serving shape (B = 128, 7 s, hop
// 160) that is 2.41e8 B, 0.072 ms at 3.35 TB/s, against 2.5e9 FLOP of real
// FFTs, 0.038 ms at 67 TFLOP/s. The TPU kernel did the DFT as a matrix
// product (75x the FLOP) because the MXU is that chip's fast unit; here
// products are cheap and bytes are scarce, so the frame is transformed by an
// FFT and nothing but the wav and the output touches device memory. K1b
// writes 80 floats a frame instead of 513 (8.6e7 B at the serving shape,
// 0.026 ms), and the shipped Slaney basis is banded: each bin feeds at most
// two bands (1001 nonzeros of 41,040), so its product is 2 x 1001 FLOP a
// frame, not 2 x 513 x 80. With the least real FFT (split radix, 2 N log2 N
// - 4 N + 6 FLOP), the window, the squares and the dB that is 2.0e9 FLOP at
// the serving shape, 0.030 ms at 67 TFLOP/s: K1b's bound is operations.
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
//   k = t + 64 i (i < 4) and bins k and 512 - k, thread 0 also bin 256.
// - Window, twiddles and untangle factors come from one host-built f32 table
//   (float64 in numpy, rounded once). A thread keeps its window and
//   twiddles in registers across its frames, and reads its untangle
//   factors from the table (L1) where they are used, which leaves the
//   registers the mel product needs (80 a thread, none spilled). No
//   fast-math intrinsics in the FFT. The dB takes log2 from the
//   special-function unit (__log2f: absolute error at most 2^-22 outside
//   [0.5, 2], 2 ulp inside, so under 1e-6 dB) times log10(2), a shorter
//   sequence than the precise logf.
// - What bounds it, measured on an H100: shared-memory traffic (the L1 and
//   shared-memory pipe). The FFT's exchanges are most of K1's time; the
//   log-mel epilogue adds the table reads, the dB row and the mel
//   product's reads of it and of the weights (1001 terms a frame), so a
//   log-mel launch takes about twice K1's time although it writes a sixth
//   of the bytes.
// - The epilogue is a template parameter:
//   kPower   writes the 513 powers (K1); neighbouring threads write
//            neighbouring 4-byte bins of the frame's row, each exactly once.
//   kPowerMax  kPower, and each row's largest power besides: a running max
//            in registers, a warp shuffle, one atomicMax a warp on the
//            float's bits as unsigned. Power is >= +0, so the bit order is
//            the value order and the result does not depend on the order of
//            the blocks.
//   kLogMel  turns each power the untangle gives into dB (for 'same'
//            against the row's max, read once a block), writes it to the
//            frame's second exchange buffer, which pass 3 has finished
//            reading, and after one more barrier forms the mel bands from
//            a host-built schedule: in each slot thread t sums one piece of
//            a band, db[k_lo + j] W[off + j s] for j < n (band_sum: four
//            partial sums in flight). The bands are 4 to 37 bins long, so
//            the widest are halved, their halves on lanes l and l ^ 16 and
//            added by one shuffle, and a warp's longest pieces add up to
//            25 terms where whole bands took 43; the halving points are
//            chosen so that a warp's pieces mostly start in different
//            banks of the dB row. The pieces cover each band's exact
//            nonzero range of the fixed Slaney basis: skipping exact zeros
//            changes no sum, only the order of the nonzero terms.
//   kLogMelFromPower  kLogMel on power rows read from device memory, each
//            thread's bins a frame ahead: no slab, no FFT; one barrier a
//            frame.
//   The mel weights of the fixed basis are staged in shared memory once a
//   block where the block has 8 frames or more (6.5 KB for the shipped
//   basis), one region a slot, each thread's piece an odd number of floats
//   from the next thread's, so every weight is read at the thread's base
//   plus an immediate, in distinct banks across a warp. Smaller blocks
//   read the weights from device memory.
//   'same' is two launches in one stream with no host sync between them:
//   kPowerMax into a zeroed [B] buffer, then kLogMelFromPower. Running the
//   FFT twice instead (a max-only pass, then kLogMel against it), so that
//   the power never reaches device memory, measured slower on an H100
//   (ops/log_mel_spectrogram.py).
// - A given [513, n_mels] matrix (a trainable basis) has no zeros to skip:
//   K1 writes the power (kPower, or kPowerMax for 'same'), then
//   dense_mel_kernel forms the product as a tiled matrix product, the dB
//   taken as each power is staged in shared memory. Each thread keeps 4
//   frames x kMJ bands in registers, so a term costs 0.3 shared-memory
//   reads where the banded walk's one term a thread costs two.
// - Barriers: the 64 threads of a frame wait only for each other (a named
//   barrier per group), three times a frame for the FFT; the slab is
//   read-only after the block's first barrier. kPower and kPowerMax swap
//   the two exchange buffers each frame (the next frame's exchange 1
//   goes where this frame's exchange 2 was, read before the last barrier).
//   kLogMel adds the dB barrier and keeps the buffers in place: the next
//   frame's exchange 1 overwrites Z, which the untangle read before the dB
//   barrier, and its exchange 2 overwrites the dB row only after the next
//   barrier. kLogMelFromPower swaps, so a dB row is overwritten two frames
//   later, after a barrier.

#include <cuda_runtime.h>
#include <math_constants.h>

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

constexpr float kAmin = 1e-10f;          // dB floor of the power
enum Epilogue : int {
  kPower = 0,
  kLogMel = 1,
  kPowerMax = 2,
  kLogMelFromPower = 3,
};

struct Params {
  const float* wav;        // [B, T]
  const float* tables;     // window | tw1 | tw2 | untangle
  const float* power_in;   // kLogMelFromPower: [B, n_frames, 513]
  float* out;              // power [B, n_frames, 513] or log-mel [.., n_mels]
  unsigned* row_max;       // [B] max power bits, or null
  const int* sched;        // [mel_slots, 4, 64]: k_lo, n, off, code
  const float* mel_w;      // band weights
  int T, hop, lo, n_frames, tile_frames, tiles, vec16;
  int n_mels, mel_slots;
  int w_smem;              // weight floats staged in shared memory, or 0
  float db_scale;          // 10 log10(2) ('same') or log10(2) ('valid')
  float db_floor;          // -range ('same') or -inf ('valid')
};

// the 64 threads of frame group g wait for each other (named barrier g + 1;
// barrier 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kFrameThreads)
               : "memory");
}

// dB of one power: for 'same' against the row's reference level `ref`
__device__ __forceinline__ float to_db(float v, float scale, float ref,
                                       float floor) {
  return fmaxf(__fmul_rn(scale, __log2f(fmaxf(v, kAmin))) - ref, floor);
}

// sum over j < n of d[j] w[j], with four partial sums in flight: term j
// on p[j mod 4], then (p0 + p1) + (p2 + p3)
__device__ __forceinline__ float band_sum(const float* d, const float* w,
                                          int n) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int j = 0;
  for (; j + 4 <= n; j += 4) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[r] = fmaf(d[j + r], __ldg(w + j + r), acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (j + r < n) acc[r] = fmaf(d[j + r], __ldg(w + j + r), acc[r]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// band_sum over weights staged in shared memory: every address is the
// thread's base plus an immediate
__device__ __forceinline__ float band_sum_smem(const float* d,
                                               const float* w, int n) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int j = 0;
  for (; j + 4 <= n; j += 4) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = fmaf(d[j + r], w[j + r], acc[r]);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (j + r < n) acc[r] = fmaf(d[j + r], w[j + r], acc[r]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

template <int kEpi>
__global__ void __launch_bounds__(kMaxGroups * kFrameThreads, 3)
frontend_kernel(const Params p) {
  constexpr bool kFft = kEpi != kLogMelFromPower;
  constexpr bool kMel = kEpi == kLogMel || kEpi == kLogMelFromPower;
  constexpr bool kStore = kEpi == kPower || kEpi == kPowerMax;
  constexpr bool kTrackMax = kEpi == kPowerMax;
  extern __shared__ float4 smem4[];
  float* slab = reinterpret_cast<float*>(smem4);
  const int slab_len = (p.tile_frames - 1) * p.hop + kNfft;
  const int slab_pad = (slab_len + 3) & ~3;
  float2* bufs = reinterpret_cast<float2*>(slab + slab_pad);

  const int tid = threadIdx.x;
  const int t = tid & (kFrameThreads - 1);
  const int g = tid / kFrameThreads;
  const int groups = blockDim.x / kFrameThreads;
  const int tile = blockIdx.x % p.tiles;
  const int b = blockIdx.x / p.tiles;
  const int f0 = tile * p.tile_frames;
  // the mel weights staged after the exchange buffers (w_smem floats)
  float* w_s = reinterpret_cast<float*>(bufs + groups * 2 * kBufFloat2);

  if constexpr (kFft) {
    const long long s0 = static_cast<long long>(f0) * p.hop - p.lo;
    const float* x = p.wav + static_cast<size_t>(b) * p.T;
    // slab[i] = x[s0 + i], zero outside [0, T): the pads are virtual
    if (p.vec16) {
      // s0, T and the row stride are multiples of 4 samples, so a 16-byte
      // chunk lies wholly inside or wholly outside the row
      float4* slab4 = reinterpret_cast<float4*>(slab);
      for (int c = tid; c < slab_pad / 4; c += blockDim.x) {
        const long long s = s0 + 4 * c;
        if (s >= 0 && s + 4 <= p.T) {
          cp_async_16(slab4 + c, x + s);
        } else {
          slab4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    } else {
      for (int i = tid; i < slab_len; i += blockDim.x) {
        const long long s = s0 + i;
        if (s >= 0 && s < p.T) {
          cp_async_4(slab + i, x + s);
        } else {
          slab[i] = 0.f;
        }
      }
    }
  }
  if constexpr (kMel) {
    for (int i = tid; i < p.w_smem; i += blockDim.x) {
      w_s[i] = __ldg(p.mel_w + i);
    }
  }

  // this thread's table entries (see the design notes)
  const int k1b = t >> 3;  // pass 2: sub-transform
  const int t2 = t & 7;    // pass 2: residue
  const float2* tab = reinterpret_cast<const float2*>(p.tables);
  const float2* win_tab = tab + kWinOff / 2 + t;
  const float2* tw1_tab = tab + kTw1Off / 2 + t;
  const float2* tw2_tab = tab + kTw2Off / 2 + t2;
  const float2* ut_tab = tab + kUtOff / 2;
  float2 win[8], tw1[8], tw2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    win[j] = __ldg(win_tab + kFrameThreads * j);
    tw1[j] = __ldg(tw1_tab + kFrameThreads * j);
    tw2[j] = __ldg(tw2_tab + 8 * j);
  }
  auto ut = [&](int i) {
    return __ldg(ut_tab + (i < 4 ? t + kFrameThreads * i : kHalf / 2));
  };
  if constexpr (kFft) cp_async_wait_all();
  // 'same': this row's reference level, from the first launch's max
  float ref = 0.f;
  if (kMel && p.row_max != nullptr) {
    ref = to_db(__uint_as_float(p.row_max[b]), p.db_scale, 0.f, -CUDART_INF_F);
  }
  float run_max = 0.f;
  // kLogMelFromPower: the powers of the thread's bins in its next frame
  // (bins t + 64 i and 512 - t - 64 i, then 256), loaded a frame ahead so
  // that the loads' latency overlaps the frame before
  float next_power[9] = {};
  auto fetch_power = [&](int fl) {
    const int f = f0 + fl;
    if (fl >= p.tile_frames || f >= p.n_frames) return;
    const float* row = p.power_in + (static_cast<size_t>(b) * p.n_frames +
                                     f) * (kHalf + 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      next_power[2 * i] = row[t + kFrameThreads * i];
      next_power[2 * i + 1] = row[kHalf - t - kFrameThreads * i];
    }
    next_power[8] = t == 0 ? row[kHalf / 2] : 0.f;
  };
  if constexpr (!kFft) fetch_power(g);
  __syncthreads();

  float2* buf_a = bufs + (2 * g) * kBufFloat2;
  float2* buf_b = buf_a + kBufFloat2;
  const bool hop_even = (p.hop & 1) == 0;

  // tile_frames is a multiple of groups, so every thread of a group meets
  // every barrier of its group
  for (int fl = g; fl < p.tile_frames; fl += groups) {
    const int f = f0 + fl;
    const bool valid = f < p.n_frames;
    const size_t frame_row = static_cast<size_t>(b) * p.n_frames + f;
    // the epilogue of one bin's power v: K1 stores it (and folds it into
    // the running max for 'same'), the log-mel epilogue writes its dB into the
    // frame's second exchange buffer (free: pass 3 read it before the last
    // barrier)
    float* db = reinterpret_cast<float*>(buf_b);
    float* power_row = p.out + frame_row * (kHalf + 1);
    auto emit = [&](int k, float v) {
      if constexpr (kMel) {
        db[k] = to_db(v, p.db_scale, ref, p.db_floor);
      } else if (valid) {
        if constexpr (kStore) power_row[k] = v;
        if constexpr (kTrackMax) run_max = fmaxf(run_max, v);
      }
    };

    if constexpr (kFft) {
      const float* frame = slab + fl * p.hop;
      float2 a[8];
      if (hop_even) {
        const float2* frame2 = reinterpret_cast<const float2*>(frame);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 v = frame2[t + kFrameThreads * j];
          const float2 w = win[j];
          a[j] = make_float2(v.x * w.x, v.y * w.y);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int m = t + kFrameThreads * j;
          const float2 w = win[j];
          a[j] = make_float2(frame[2 * m] * w.x, frame[2 * m + 1] * w.y);
        }
      }

      // pass 1: over j, m = t + 64 j
      fft8(a);
      buf_a[t] = a[0];
#pragma unroll
      for (int k1 = 1; k1 < 8; ++k1) {
        buf_a[k1 * kEx1Stride + t] = cmul(a[k1], tw1[k1]);
      }
      group_sync(g);

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
      group_sync(g);

      // pass 3: over t2, for (k1, k2) = (t & 7, t >> 3); Z[t + 64 k3]
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = buf_b[r * kEx2Stride + t];
      fft8(a);
#pragma unroll
      for (int k3 = 0; k3 < 8; ++k3) buf_a[t + kFrameThreads * k3] = a[k3];
      group_sync(g);

      // untangle the real transform and square
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = t + kFrameThreads * i;
        const float2 zk = buf_a[k];
        const float2 zr = buf_a[(kHalf - k) & (kHalf - 1)];
        const float2 sum = make_float2(zk.x + zr.x, zk.y - zr.y);
        const float2 dif = make_float2(zk.x - zr.x, zk.y + zr.y);
        const float2 rot = cmul(ut(i), dif);
        emit(k, 0.25f * norm2(cadd(sum, rot)));
        emit(kHalf - k, 0.25f * norm2(csub(sum, rot)));
      }
      if (t == 0) {
        const float2 z = buf_a[kHalf / 2];
        const float2 sum = make_float2(2.f * z.x, 0.f);
        const float2 dif = make_float2(0.f, 2.f * z.y);
        emit(kHalf / 2, 0.25f * norm2(cadd(sum, cmul(ut(4), dif))));
      }
    } else {
      // this frame's powers came with the last frame; fetch the next's
      float cur[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) cur[i] = next_power[i];
      fetch_power(fl + groups);
      if (valid) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = t + kFrameThreads * i;
          emit(k, cur[2 * i]);
          emit(kHalf - k, cur[2 * i + 1]);
        }
        if (t == 0) emit(kHalf / 2, cur[8]);
      }
    }

    if constexpr (kMel) {
      group_sync(g);
      if (valid) {
        // slot by slot, this thread's piece of a band: sum over j < n of
        // db[k_lo + j] W[off + j s]; the halves of a band meet across
        // lanes t and t ^ 16 (valid is the same for the whole group)
        float* row = p.out + frame_row * p.n_mels;
        for (int sl = 0; sl < p.mel_slots; ++sl) {
          const int* e = p.sched + sl * 4 * kFrameThreads + t;
          const int k_lo = __ldg(e);
          const int n = __ldg(e + kFrameThreads);
          const int off = __ldg(e + 2 * kFrameThreads);
          const int code = __ldg(e + 3 * kFrameThreads);
          const float acc =
              p.w_smem > 0 ? band_sum_smem(db + k_lo, w_s + off, n)
                           : band_sum(db + k_lo, p.mel_w + off, n);
          const float other = __shfl_xor_sync(0xffffffffu, acc, 16);
          if (code >= 0) row[code >> 1] = (code & 1) ? acc + other : acc;
        }
      }
    }
    if constexpr (kEpi != kLogMel) {
      float2* swap = buf_a;
      buf_a = buf_b;
      buf_b = swap;
    }
  }

  if constexpr (kTrackMax) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      run_max = fmaxf(run_max, __shfl_xor_sync(0xffffffffu, run_max, o));
    }
    if ((tid & 31) == 0) atomicMax(p.row_max + b, __float_as_uint(run_max));
  }
}

template <int kEpi>
int launch(const Params& p, int blocks, int threads, long long smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      frontend_kernel<kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  frontend_kernel<kEpi><<<blocks, threads, static_cast<size_t>(smem),
                          stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kFreq = kHalf + 1;      // bins of a power row
constexpr int kDenseRows = 64;        // frames a block of dense_mel_kernel
constexpr int kDenseK = 16;           // bins a step
constexpr int kDenseRowsPad = 68;     // a_s row: float4-aligned, 2-way banks
constexpr int kDenseThreads = 256;    // 16 x 16: band lanes x frame quads
constexpr int kDenseMelsMJ = 5;       // 16 x 5 = 80 bands, the shipped width
constexpr int kDenseWideMJ = 8;       // wider bases: tiles of 128 bands

// out[r, m] = sum_k db(power[r, k]) w[k, m] for the rows r < rows of
// [rows, 513] power (row r of batch row r / n_frames) and the bands
// m0 <= m < m0 + 16 kMJ, m0 = 16 kMJ blockIdx.y, of a row-major [513,
// n_mels] matrix. A block owns 64 rows; per step of 16 bins it stages their
// dB ([16][64], transposed) and the weights ([16][16 kMJ]) in shared memory,
// and thread (ty, tx) adds the terms of rows 4 ty .. 4 ty + 3 and bands
// tx + 16 j, j < kMJ, one fmaf a term in the order of k.
template <int kMJ>
__global__ void __launch_bounds__(kDenseThreads)
dense_mel_kernel(const float* __restrict__ power,
                 const unsigned* __restrict__ row_max,
                 const float* __restrict__ w, float* __restrict__ out,
                 int rows, int n_frames, int n_mels, float db_scale,
                 float db_floor) {
  constexpr int kCols = 16 * kMJ;
  __shared__ __align__(16) float a_s[kDenseK][kDenseRowsPad];
  __shared__ float w_s[kDenseK][kCols];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * kDenseRows;
  const int m0 = blockIdx.y * kCols;
  // the powers this thread stages: bin k0 + tx of rows r0 + ty + 16 i
  const float* src[4];
  float ref[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    live[i] = r < rows;
    const int rc = live[i] ? r : rows - 1;
    src[i] = power + static_cast<size_t>(rc) * kFreq;
    ref[i] = row_max == nullptr
                 ? 0.f
                 : to_db(__uint_as_float(__ldg(row_max + rc / n_frames)),
                         db_scale, 0.f, -CUDART_INF_F);
  }
  float acc[4][kMJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kMJ; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < kFreq; k0 += kDenseK) {
    const int k = k0 + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a_s[tx][ty + 16 * i] =
          live[i] && k < kFreq
              ? to_db(__ldg(src[i] + k), db_scale, ref[i], db_floor)
              : 0.f;
    }
    for (int e = tid; e < kDenseK * kCols; e += kDenseThreads) {
      const int kk = e / kCols, c = e - kk * kCols;
      const int kw = k0 + kk, m = m0 + c;
      w_s[kk][c] = kw < kFreq && m < n_mels
                       ? __ldg(w + static_cast<size_t>(kw) * n_mels + m)
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDenseK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][4 * ty]);
#pragma unroll
      for (int j = 0; j < kMJ; ++j) {
        const float b = w_s[kk][tx + 16 * j];
        acc[0][j] = fmaf(a.x, b, acc[0][j]);
        acc[1][j] = fmaf(a.y, b, acc[1][j]);
        acc[2][j] = fmaf(a.z, b, acc[2][j]);
        acc[3][j] = fmaf(a.w, b, acc[3][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kMJ; ++j) {
      const int m = m0 + tx + 16 * j;
      if (m < n_mels) out[static_cast<size_t>(r) * n_mels + m] = acc[i][j];
    }
  }
}

template <int kMJ>
int launch_dense(const float* power, const unsigned* row_max, const float* w,
                 float* out, int rows, int n_frames, int n_mels,
                 float db_scale, float db_floor, cudaStream_t stream) {
  const dim3 grid((rows + kDenseRows - 1) / kDenseRows,
                  (n_mels + 16 * kMJ - 1) / (16 * kMJ));
  dense_mel_kernel<kMJ><<<grid, kDenseThreads, 0, stream>>>(
      power, row_max, w, out, rows, n_frames, n_mels, db_scale, db_floor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// What the host must build the table for and how long it is.
int tasr_power_spectrogram_n_fft() { return kNfft; }
int tasr_power_spectrogram_table_floats() { return kTableFloats; }

// Shared memory one block needs, in bytes: the slab, two exchange buffers
// for each frame in flight, then `w_smem` floats of staged mel weights.
long long tasr_power_spectrogram_smem_bytes(int hop, int tile_frames,
                                            int groups, int w_smem) {
  const long long slab_len =
      static_cast<long long>(tile_frames - 1) * hop + kNfft;
  const long long slab_pad = (slab_len + 3) & ~3LL;
  return (slab_pad + w_smem) * static_cast<long long>(sizeof(float)) +
         static_cast<long long>(groups) * 2 * kBufFloat2 *
             static_cast<long long>(sizeof(float2));
}

// Launches the epilogue `epi` (0 power, 1 log-mel, 2 power and max, 3
// log-mel from power) on `stream`: blocks of `groups` x 64 threads, each
// over `tile_frames` frames (a multiple of `groups`) of one batch row.
// `vec16` selects 16-byte slab copies: the caller guarantees that wav, T,
// lo and tile_frames * hop are all multiples of 16 bytes / 4 samples.
// `row_max` is ignored by epilogue 0, may be null for 1 and 3 ('valid' dB)
// and is needed by 2. The log-mel epilogues follow the schedule
// `sched` [mel_slots, 4, 64] (k_lo, n, off, code; see kLogMel) and stage
// `w_smem` floats of `mel_w` in shared memory, or read `mel_w` from device
// memory where `w_smem` is 0. Returns cudaGetLastError() of the launch
// (0 = ok).
int tasr_frontend(int epi, const float* wav, const float* tables,
                  const float* power_in, float* out, unsigned* row_max,
                  const int* sched, const float* mel_w, int batch, int T,
                  int hop, int lo, int n_frames, int tile_frames, int groups,
                  int vec16, int n_mels, int mel_slots, int w_smem, float db_scale, float db_floor, void* stream) {
  if (batch <= 0 || T <= 0 || n_frames <= 0 || hop <= 0 || lo < 0 ||
      groups <= 0 || groups > kMaxGroups || tile_frames <= 0 ||
      tile_frames % groups != 0 || epi < kPower || epi > kLogMelFromPower ||
      w_smem < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool mel = epi == kLogMel || epi == kLogMelFromPower;
  if ((epi == kPowerMax && row_max == nullptr) ||
      (epi == kLogMelFromPower && power_in == nullptr) || out == nullptr ||
      (mel && (sched == nullptr || mel_w == nullptr || n_mels <= 0 ||
               mel_slots <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (n_frames + tile_frames - 1) / tile_frames;
  if (tiles * batch > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = tasr_power_spectrogram_smem_bytes(
      hop, tile_frames, groups, mel ? w_smem : 0);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  Params p{wav, tables, power_in, out, row_max, sched, mel_w,
           T, hop, lo, n_frames, tile_frames, static_cast<int>(tiles), vec16,
           n_mels, mel_slots, mel ? w_smem : 0, db_scale, db_floor};
  const int blocks = static_cast<int>(tiles * batch);
  const int threads = groups * kFrameThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case kPower: return launch<kPower>(p, blocks, threads, smem, s);
    case kLogMel: return launch<kLogMel>(p, blocks, threads, smem, s);
    case kPowerMax: return launch<kPowerMax>(p, blocks, threads, smem, s);
    default:
      return launch<kLogMelFromPower>(p, blocks, threads, smem, s);
  }
}

// The mel product of a given row-major [513, n_mels] matrix `w` on `rows`
// power rows [rows, 513] (batch row r / n_frames), each power turned into dB
// first: db_scale log2(max(p, 1e-10)) against the batch row's `row_max`
// where given ('same'), floored at db_floor. Writes out [rows, n_mels].
// Returns cudaGetLastError() of the launch (0 = ok).
int tasr_dense_mel(const float* power, const unsigned* row_max,
                   const float* w, float* out, int rows, int n_frames,
                   int n_mels, float db_scale, float db_floor, void* stream) {
  if (power == nullptr || w == nullptr || out == nullptr || rows <= 0 ||
      n_frames <= 0 || n_mels <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_mels <= 16 * kDenseMelsMJ) {
    return launch_dense<kDenseMelsMJ>(power, row_max, w, out, rows, n_frames,
                                      n_mels, db_scale, db_floor, s);
  }
  return launch_dense<kDenseWideMJ>(power, row_max, w, out, rows, n_frames,
                                    n_mels, db_scale, db_floor, s);
}

const char* tasr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
