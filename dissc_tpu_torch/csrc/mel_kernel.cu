// Fused log-mel spectrogram for Hopper (sm_90a).
//
// Replaces dissc_tpu/kernels/mel_kernel.py::mel_spectrogram_pallas (the
// Pallas kernel _mel_kernel).  For every frame of a [B, T] float32 waveform:
//   reflect-pad (n_fft - hop)/2 at both ends, frame n_fft samples at hop,
//   re/im = frame . (window-folded cos/sin DFT bases),
//   mag = sqrt(re^2 + im^2 + 1e-9), mel = mag . melT [freq, num_mels],
//   out[b, m, f] = log(max(mel, 1e-5)).
// The magnitudes live only in shared memory.
//
// Bound: fp32 operations.  This design computes the DFT densely: at the
// vocoder's train shape (64 x 8960, n_fft 1024, hop 256) it does ~4.7
// GFLOP on ~7.4 MB (bases included), ~640 FLOP/byte, far above the card's
// fp32 ridge.  (A real FFT would need ~70x fewer operations; the least
// time of the function is in chip_smoke.py's mel_bound_ms.)  So the two
// DFT products run as one SIMT matrix product C[frames, n_fft] =
// frames[frames, n_fft] x basis[n_fft, n_fft] in IEEE fp32 FMA (no TF32),
// tiled for reuse:
//   * a block owns BM frames x BN basis columns; a thread owns an 8 x 8
//     register tile, so each pair of 16-byte shared loads feeds 64 FMAs;
//   * frames are gathered straight from the waveform into shared memory
//     (reflect padding folded into the index; overlapping frames re-read
//     from L2, never copied in device memory); tiles are double-buffered
//     through registers, one barrier per k step;
//   * basis columns are interleaved (cos k, sin k), so a thread holds the
//     real and imaginary parts of its frequencies and takes magnitudes in
//     registers.  Pair 0 carries (cos 0, cos n_fft/2): both sines are zero,
//     so n_fft columns hold all n_fft/2 + 1 frequencies;
//   * each block projects its BN/2 frequencies onto the mel basis into a
//     partial sum; a second, small kernel adds the n_fft/BN partials in a
//     fixed order (deterministic) and takes the log.
// An FFT-based body is later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 32;                          // frames per block
constexpr int BN = 128;                         // basis columns per block
constexpr int BK = 8;                           // samples per k step
constexpr int THREADS = (BM / 8) * (BN / 8);    // one 8 x 8 tile each: 64
constexpr int PAIRS = BN / 2;                   // frequencies per block
constexpr int AS_STRIDE = BM + 4;               // conflict-free transposed stores
constexpr int A_LOADS = BM * BK / THREADS;      // 4
constexpr int B_LOADS = BK * BN / 4 / THREADS;  // 4 float4

__global__ void __launch_bounds__(THREADS)
mel_dft_kernel(const float* __restrict__ y,        // [B, T]
               const float* __restrict__ basis,    // [n_fft, n_fft] interleaved
               const float* __restrict__ mel_t,    // [n_fft/2 + 1, num_mels]
               const int2* __restrict__ spans,     // [n_fft/BN, num_mels]
               float* __restrict__ partial,        // [n_fft/BN, B*F, num_mels]
               int t_len, int n_frames, int total, int n_fft, int hop,
               int num_mels) {
  __shared__ __align__(16) float As[2][BK][AS_STRIDE];
  __shared__ __align__(16) float Bs[2][BK][BN];
  __shared__ float mags[BM][PAIRS + 1];  // column PAIRS: the n_fft/2 bin

  const int tid = threadIdx.x;
  const int tx = tid % (BN / 8);  // columns tx*4 + [0,4) and BN/2 + tx*4 + [0,4)
  const int ty = tid / (BN / 8);  // rows    ty*4 + [0,4) and BM/2 + ty*4 + [0,4)
  const int m0 = blockIdx.x * BM;
  const int cb = blockIdx.y;
  const int pad = (n_fft - hop) / 2;

  // Frame rows this thread gathers: element e = tid + i*THREADS of the
  // BM x BK tile is (row e / BK, sample e % BK); THREADS % BK == 0.
  const int kk_a = tid % BK;
  const float* yrow[A_LOADS];
  int start[A_LOADS];
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    const int g = m0 + (tid + i * THREADS) / BK;
    yrow[i] = nullptr;
    start[i] = 0;
    if (g < total) {
      const int b = g / n_frames;
      yrow[i] = y + (size_t)b * t_len;
      start[i] = (g - b * n_frames) * hop - pad + kk_a;
    }
  }
  const float* bcol = basis + (size_t)cb * BN;

  float ra[A_LOADS];
  float4 rb[B_LOADS];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      float v = 0.f;
      if (yrow[i]) {
        int j = start[i] + k0;
        if (j < 0) j = -j;
        if (j >= t_len) j = 2 * (t_len - 1) - j;
        v = __ldg(yrow[i] + j);
      }
      ra[i] = v;
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int q = tid + i * THREADS;
      rb[i] = __ldg(reinterpret_cast<const float4*>(
          bcol + (size_t)(k0 + q / (BN / 4)) * n_fft) + q % (BN / 4));
    }
  };
  auto store_tiles = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i)
      As[buf][kk_a][(tid + i * THREADS) / BK] = ra[i];
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int q = tid + i * THREADS;
      *reinterpret_cast<float4*>(&Bs[buf][q / (BN / 4)][(q % (BN / 4)) * 4]) = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_tiles(0);
  store_tiles(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < n_fft; k0 += BK) {
    const bool more = k0 + BK < n_fft;
    if (more) load_tiles(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][BN / 2 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store_tiles(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  // Magnitudes of this thread's 8 frames x 4 frequencies.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4) ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int pl = (j < 4) ? tx * 2 + j / 2 : PAIRS / 2 + tx * 2 + (j - 4) / 2;
      const float re = acc[i][j], im = acc[i][j + 1];
      if (cb == 0 && pl == 0) {  // (cos 0, cos n_fft/2): both sines are zero
        mags[r][0] = sqrtf(re * re + 1e-9f);
        mags[r][PAIRS] = sqrtf(im * im + 1e-9f);
      } else {
        mags[r][pl] = sqrtf(re * re + im * im + 1e-9f);
      }
    }
  }
  __syncthreads();

  // This block's frequencies projected onto the mel basis.  A triangular
  // filter covers few bins: spans[cb][m] is the [first, last) range of
  // this block's bins where filter m is non-zero (the zeros would add
  // exact zeros to the sum).
  const float* mel_blk = mel_t + (size_t)cb * PAIRS * num_mels;
  const float* mel_nyq = mel_t + (size_t)(n_fft / 2) * num_mels;
  const int2* span = spans + (size_t)cb * num_mels;
  for (int o = tid; o < BM * num_mels; o += THREADS) {
    const int r = o / num_mels;
    const int m = o - r * num_mels;
    const int g = m0 + r;
    if (g >= total) continue;
    const int2 sp = span[m];
    float s = 0.f;
    for (int pl = sp.x; pl < sp.y; ++pl)
      s = fmaf(mags[r][pl], __ldg(mel_blk + pl * num_mels + m), s);
    if (cb == 0) s = fmaf(mags[r][PAIRS], __ldg(mel_nyq + m), s);
    partial[((size_t)cb * total + g) * num_mels + m] = s;
  }
}

// out[b, m, f] = log(max(sum over column blocks of partial, 1e-5)).
__global__ void mel_log_kernel(const float* __restrict__ partial,
                               float* __restrict__ out, int n_frames, int total,
                               int num_mels, int n_blocks) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total * num_mels) return;
  const int f = idx % n_frames;
  const int bm = idx / n_frames;
  const int m = bm % num_mels;
  const int g = (bm / num_mels) * n_frames + f;
  float s = 0.f;
  for (int c = 0; c < n_blocks; ++c) s += partial[((size_t)c * total + g) * num_mels + m];
  out[idx] = logf(fmaxf(s, 1e-5f));
}

}  // namespace

extern "C" {

// Launches the fused log-mel on `stream` (two kernels).  `basis` is the
// interleaved [n_fft, n_fft] window-folded DFT basis, `spans` the
// [n_fft/128, num_mels, 2] int32 non-zero bin ranges, `partial` scratch of
// (n_fft / 128) * batch * n_frames * num_mels floats.  Returns the CUDA
// error code (0 on success).  The caller checks hop | n_fft,
// n_fft % 128 == 0 and t_len > (n_fft - hop)/2.
int mel_spectrogram_launch(const float* y, const float* basis, const float* mel_t,
                           const int* spans, float* partial, float* out, int batch, int t_len,
                           int n_frames, int n_fft, int hop, int num_mels,
                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int total = batch * n_frames;
  const int n_blocks = n_fft / BN;
  const dim3 grid((total + BM - 1) / BM, n_blocks);
  mel_dft_kernel<<<grid, THREADS, 0, s>>>(y, basis, mel_t,
                                          reinterpret_cast<const int2*>(spans), partial,
                                          t_len, n_frames, total, n_fft, hop, num_mels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_out = total * num_mels;
  mel_log_kernel<<<(n_out + 255) / 256, 256, 0, s>>>(partial, out, n_frames, total,
                                                     num_mels, n_blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
