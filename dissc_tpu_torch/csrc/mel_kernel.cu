// Fused log-mel spectrogram for Hopper (sm_90a): one launch, a real FFT
// in shared memory.
//
// Replaces dissc_tpu/kernels/mel_kernel.py::mel_spectrogram_pallas (the
// Pallas kernel _mel_kernel, which multiplies frames by dense
// window-folded cos/sin DFT bases on the MXU).  For a [B, T] float32
// waveform it computes out[b, m, f], [B, num_mels, F]:
//   reflect-pad (n_fft - hop)/2 at both ends, frame n_fft samples at hop,
//   apply the periodic Hann window (centre-padded when win < n_fft),
//   X = one-sided DFT, mag = sqrt(re^2 + im^2 + 1e-9),
//   mel = slaney mel basis . mag, out = log(max(mel, 1e-5)).
// It takes every config the Pallas kernel takes (hop | n_fft, win <=
// n_fft) up to n_fft 4096: any n_fft, not only powers of two.
//
// Bound: fp32 operations.  A windowed real FFT, the magnitudes, the
// sparse mel sum and the log come to ~31 kFLOP a frame at n_fft 1024
// (~69 MFLOP on the 2,240 frames of the train step's [64, 8960]), on ~3 MB
// that must move: about 1 us at the card's fp32 peak either way.  A launch
// of a few thousand frames comes nowhere near either peak: its time is set
// inside the SMs, by instruction issue, shared-memory round trips (five
// FFT stages) and barriers, and at a few hundred frames by one block's
// latency.  So the design keeps every intermediate on chip and does the
// least work:
//   * a block owns G consecutive frames of one batch row and reads their
//     waveform span, (G - 1) * hop + n_fft samples, into shared memory once
//     in coalesced asynchronous copies, the reflect padding folded into the
//     index; no padded or framed copy goes to device memory.  G = 2 puts
//     1,152 blocks in flight at the train shape and 160 at [2, 40960] (320
//     frames), more than the 132 SMs either way;
//   * per frame the real n_fft-point DFT is, for an even n_fft, one complex
//     FFT of N = n_fft/2 points: z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1],
//     then the split step
//     X[k] = (Z[k] + Z*[N-k])/2 - i e^{-2 pi i k / n_fft} (Z[k] - Z*[N-k])/2,
//     k = 0..N, Z[N] = Z[0].  An odd n_fft takes a complex FFT of N = n_fft
//     points of the real frame and bins 0..(N-1)/2.  That is ~2.5 n_fft
//     log2 n_fft operations a frame where a dense DFT does 2 n_fft^2 (80x
//     more at 1024);
//   * the FFT is a Stockham (self-sorting) one, ping-ponging between two
//     shared buffers, over the factors of N taken in that order: radix 4
//     while 4 divides what is left (512 = 4^4 * 2), then one radix 2, then
//     the odd primes from the smallest, each as a direct DFT of its size
//     (500 = 4 * 5^3).  The first stage packs z straight from the span.  A
//     power-of-two N >= 2 has an instantiation of its own: radix 4 and 2
//     only, packed, index arithmetic in shifts and masks, so that the code
//     for other sizes costs it no registers; any other N does divisions;
//   * twiddles e^{-2 pi i j / n_fft} come from a table computed in float64
//     on the host and rounded to fp32 (no sin/cos intrinsics, no fast
//     math): j < N entries, the other half circle of an even n_fft being
//     the same table negated;
//   * the magnitudes of a frame (N + 1, or (N + 1)/2 for an odd n_fft) stay
//     in shared memory;
//   * the mel projection reads only each filter's non-zero bins, from a
//     CSR table (first bin, row pointer, weights: 1,001 weights and at most
//     37 bins a filter at the default config).  One thread per (frame, mel)
//     sums with fmaf in bin order, takes logf(fmaxf(s, 1e-5f)) and stores;
//     a block's frames are adjacent in the output, so stores come in runs.
// One launch, no scratch in device memory, no atomics: every run gives the
// same result.  Precision is IEEE fp32 throughout.  Shared memory is sized
// from n_fft, 8 (N + N/16 + 2 G N) bytes: 20.25 KB at 1024, 98 KB at 4096
// and 162 KB at 4095, above 48 KB by setting the kernel's attribute.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int G = 2;              // frames per block
static_assert(G == 2, "the mel loop splits its items into (mel, frame) for G = 2");
constexpr int MAX_THREADS = 256;  // threads per block
constexpr int MAX_N_FFT = 4096;
constexpr int MAX_STAGES = 12;    // factors of N <= 4095 (3^7 = 2187 has 7)

// The radices of the FFT's stages, in order.
struct Radices {
  int count;
  int r[MAX_STAGES];
};

// N's factors in the order the stages take them: 4 while 4 divides what is
// left, then 2, then the odd primes from the smallest.  N = 1 (n_fft 1 or
// 2) is one stage of radix 1, a copy.
Radices factor(int n) {
  Radices f{0, {}};
  if (n == 1) f.r[f.count++] = 1;
  for (; n % 4 == 0; n /= 4) f.r[f.count++] = 4;
  if (n % 2 == 0) {
    f.r[f.count++] = 2;
    n /= 2;
  }
  for (int p = 3; n > 1; p += 2)
    for (; n % p == 0; n /= p) f.r[f.count++] = p;
  return f;
}

__device__ __forceinline__ int floor_log2(int d) { return 31 - __clz(d); }

// Division by a positive d: a shift and a mask where d is a power of two.
template <bool kPow2>
struct Div {
  int d, lg;
  __device__ __forceinline__ explicit Div(int d_) : d(d_), lg(kPow2 ? floor_log2(d_) : 0) {}
  __device__ __forceinline__ int div(int a) const { return kPow2 ? a >> lg : a / d; }
  __device__ __forceinline__ int mod(int a) const { return kPow2 ? a & (d - 1) : a % d; }
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// Slot of twiddle j in shared memory: one pad every 16 entries, so that a
// stage's reads at a stride of 16, 32 or 48 entries do not all fall on
// one bank.
__device__ __forceinline__ int tw_slot(int j) { return j + (j >> 4); }

// e^{-2 pi i j / n_fft} for 0 <= j < n_fft from the table of its first n
// entries: n = n_fft/2 for an even n_fft (j >= n is the table negated),
// n = n_fft for an odd one.
template <bool kPow2>
__device__ __forceinline__ float2 twiddle(const float2* tw, int j, int n) {
  const bool hi = j >= n;
  const float2 t = tw[tw_slot(kPow2 ? j & (n - 1) : (hi ? j - n : j))];
  return hi ? make_float2(-t.x, -t.y) : t;
}

// In-place forward 4-point DFT.
__device__ __forceinline__ void radix4(float2& v0, float2& v1, float2& v2, float2& v3) {
  const float2 t0 = make_float2(v0.x + v2.x, v0.y + v2.y);
  const float2 t1 = make_float2(v0.x - v2.x, v0.y - v2.y);
  const float2 t2 = make_float2(v1.x + v3.x, v1.y + v3.y);
  const float2 t3 = make_float2(v1.y - v3.y, v3.x - v1.x);  // -i (v1 - v3)
  v0 = make_float2(t0.x + t2.x, t0.y + t2.y);
  v1 = make_float2(t1.x + t3.x, t1.y + t3.y);
  v2 = make_float2(t0.x - t2.x, t0.y - t2.y);
  v3 = make_float2(t1.x - t3.x, t1.y - t3.y);
}

// One Stockham stage of radix r on `frames` frames of n points, ns points
// already combined: reads in(f, j + q m), q < r, m = n / r, and writes
// out[f n + (j - k) r + k + p ns], p < r, k = j mod ns.  Radix 4 and 2 are
// butterflies; any other radix is a direct r-point DFT, one output a
// thread.  `in` reads the previous stage's buffer, or for the first stage
// the windowed span.
template <bool kPow2, class In>
__device__ __forceinline__ void stockham_stage(In in, float2* out, const float2* tw,
                                               int n_fft, int n, int r, int ns, int frames) {
  // Shifts for a power of two: at the train shape a thread does about one
  // butterfly a stage, so a division here costs as much as the butterfly.
  const int m = Div<kPow2>(r).div(n);
  const Div<kPow2> dm(m), dns(ns);
  const int step = Div<kPow2>(ns * r).div(n_fft);  // table index of e^{-2 pi i / (ns r)}
  const int tid = threadIdx.x, nt = blockDim.x;
  if (kPow2 || r == 4 || r == 2) {
    for (int it = tid; it < frames * m; it += nt) {
      const int f = dm.div(it), j = it - f * m, k = dns.mod(j);
      float2* o = out + f * n + (j - k) * r + k;
      if (r == 4) {
        float2 v0 = in(f, j), v1 = in(f, j + m), v2 = in(f, j + 2 * m), v3 = in(f, j + 3 * m);
        if (ns > 1) {
          v1 = cmul(v1, twiddle<kPow2>(tw, k * step, n));
          v2 = cmul(v2, twiddle<kPow2>(tw, 2 * k * step, n));
          v3 = cmul(v3, twiddle<kPow2>(tw, 3 * k * step, n));
        }
        radix4(v0, v1, v2, v3);
        o[0] = v0;
        o[ns] = v1;
        o[2 * ns] = v2;
        o[3 * ns] = v3;
      } else {
        const float2 v0 = in(f, j);
        float2 v1 = in(f, j + m);
        if (ns > 1) v1 = cmul(v1, twiddle<kPow2>(tw, k * step, n));
        o[0] = make_float2(v0.x + v1.x, v0.y + v1.y);
        o[ns] = make_float2(v0.x - v1.x, v0.y - v1.y);
      }
    }
  } else {
    const Div<kPow2> dn(n);
    const int rstep = n_fft / r;  // table index of e^{-2 pi i / r}
    for (int it = tid; it < frames * n; it += nt) {
      const int f = dn.div(it), i = it - f * n, p = dm.div(i), j = i - p * m, k = dns.mod(j);
      float2 s = make_float2(0.f, 0.f);
      for (int q = 0, pq = 0; q < r; ++q, pq = pq + p >= r ? pq + p - r : pq + p) {
        int e = q * k * step + pq * rstep;  // e^{-2 pi i (q k / (ns r) + p q / r)}
        e = e >= n_fft ? e - n_fft : e;
        const float2 v = cmul(in(f, j + q * m), twiddle<kPow2>(tw, e, n));
        s = make_float2(s.x + v.x, s.y + v.y);
      }
      out[f * n + (j - k) * r + k + p * ns] = s;
    }
  }
}

// Dynamic shared memory of one block, in bytes: the padded twiddles and
// two FFT buffers of G frames of n points.  The waveform span, (G - 1) hop
// + n_fft <= G n_fft floats, lives in the second buffer until the first
// stage has read it.
size_t smem_bytes(int n) { return 8 * (size_t)(n + n / 16 + 2 * G * n); }

template <bool kPow2>
__global__ void __launch_bounds__(MAX_THREADS)
log_mel_fft_kernel(const float* __restrict__ y,          // [B, T]
                   const float* __restrict__ window,     // [n_fft]
                   const float2* __restrict__ twiddles,  // [n]
                   const int* __restrict__ mel_lo,       // [num_mels] first bin
                   const int* __restrict__ mel_ptr,      // [num_mels + 1] into mel_w
                   const float* __restrict__ mel_w,      // [nnz]
                   float* __restrict__ out,              // [B, num_mels, F]
                   int t_len, int n_frames, int frame_blocks, int n_fft, int hop,
                   int num_mels, Radices radices) {
  extern __shared__ __align__(16) float2 smem[];
  const bool packed = kPow2 || (n_fft & 1) == 0;
  const int n = packed ? n_fft / 2 : n_fft;  // complex FFT points
  float2* tw = smem;                    // [n + n/16], see tw_slot
  float2* src = tw + n + n / 16;        // [G][n]
  float2* dst = src + G * n;            // [G][n]
  float* span = reinterpret_cast<float*>(dst);  // until stage 1 has read it

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x / frame_blocks;
  const int f0 = (blockIdx.x - b * frame_blocks) * G;
  const int frames = min(G, n_frames - f0);

  // The block's waveform span, reflect padding folded into the index
  // (the wrapper checks t_len > (n_fft - hop)/2, so one fold suffices),
  // and the twiddles: asynchronous copies to shared memory, all in flight
  // at once, so the block waits on one load latency and not on one per
  // element a thread copies.
  const float* row = y + (size_t)b * t_len;
  const int start = f0 * hop - (n_fft - hop) / 2;
  const int span_len = (frames - 1) * hop + n_fft;
  for (int i = tid; i < span_len; i += nt) {
    int j = start + i;
    j = j < 0 ? -j : j;
    j = j >= t_len ? 2 * (t_len - 1) - j : j;
    __pipeline_memcpy_async(span + i, row + j, sizeof(float));
  }
  for (int i = tid; i < n; i += nt)
    __pipeline_memcpy_async(tw + tw_slot(i), twiddles + i, sizeof(float2));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // Stage 1 (ns = 1, no twiddles) packs z from the windowed span.
  const auto from_span = [=](int f, int i) {
    const float* x = span + f * hop;
    if (!packed) return make_float2(__ldg(window + i) * x[i], 0.f);
    return make_float2(__ldg(window + 2 * i) * x[2 * i], __ldg(window + 2 * i + 1) * x[2 * i + 1]);
  };
  // A power of two takes radix 4 while it fits, then 2 (factor()'s order).
  const auto radix = [&](int s, int ns) {
    return kPow2 ? (ns * 4 <= n ? 4 : 2) : radices.r[s];
  };
  stockham_stage<kPow2>(from_span, src, tw, n_fft, n, radix(0, 1), 1, frames);
  __syncthreads();
  for (int s = 1, ns = radix(0, 1); ns < n; ++s) {
    const int r = radix(s, ns);
    const float2* in = src;
    stockham_stage<kPow2>([=](int f, int i) { return in[f * n + i]; }, dst, tw, n_fft, n, r,
                          ns, frames);
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
    ns *= r;
  }

  // Magnitudes; frame f's overwrite its slot of the free buffer (room for
  // 2n floats).
  if (packed) {
    // Split step.  Bin n takes only Z[0]: X[n] = Re Z[0] - Im Z[0], done
    // beside bin 0.
    const Div<kPow2> dn(n);
    for (int it = tid; it < frames * n; it += nt) {
      const int f = dn.div(it), k = it - f * n;
      const float2* z = src + f * n;
      float* mag = reinterpret_cast<float*>(dst + f * n);
      const float2 zk = z[k];
      const float2 zc = z[kPow2 ? (n - k) & (n - 1) : (k == 0 ? 0 : n - k)];
      const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));  // (Z[k] + Z*[N-k])/2
      const float2 d = make_float2(0.5f * (zk.x - zc.x), 0.5f * (zk.y + zc.y));  // (Z[k] - Z*[N-k])/2
      const float2 wd = cmul(tw[tw_slot(k)], d);
      const float re = e.x + wd.y, im = e.y - wd.x;  // e - i * wd
      mag[k] = sqrtf(re * re + im * im + 1e-9f);
      if (k == 0) {
        const float nyq = zk.x - zk.y;
        mag[n] = sqrtf(nyq * nyq + 1e-9f);
      }
    }
  } else {
    const int bins = n / 2 + 1;
    for (int it = tid; it < frames * bins; it += nt) {
      const int f = it / bins, k = it - f * bins;
      const float2 z = src[f * n + k];
      reinterpret_cast<float*>(dst + f * n)[k] = sqrtf(z.x * z.x + z.y * z.y + 1e-9f);
    }
  }
  __syncthreads();

  // Sparse mel projection and log, one thread per (mel, frame).
  for (int it = tid; it < num_mels * frames; it += nt) {
    const int m = frames == 2 ? it >> 1 : it, f = it - m * frames;  // frames <= G = 2
    const float* mag = reinterpret_cast<const float*>(dst + f * n) + __ldg(mel_lo + m);
    const int p0 = __ldg(mel_ptr + m), p1 = __ldg(mel_ptr + m + 1);
    float s = 0.f;
    for (int p = p0; p < p1; ++p) s = fmaf(mag[p - p0], __ldg(mel_w + p), s);
    out[((size_t)b * num_mels + m) * n_frames + f0 + f] = logf(fmaxf(s, 1e-5f));
  }
}

template <bool kPow2>
int launch(const float* y, const float* window, const float2* twiddles, const int* mel_lo,
           const int* mel_ptr, const float* mel_w, float* out, int batch, int t_len,
           int n_frames, int n_fft, int hop, int num_mels, int n, cudaStream_t stream) {
  const size_t smem = smem_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        log_mel_fft_kernel<kPow2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = G * n_fft / 8;  // one radix-4 butterfly each
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
  const int frame_blocks = (n_frames + G - 1) / G;
  log_mel_fft_kernel<kPow2><<<frame_blocks * batch, threads, smem, stream>>>(
      y, window, twiddles, mel_lo, mel_ptr, mel_w, out, t_len, n_frames, frame_blocks, n_fft,
      hop, num_mels, factor(n));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the fused log-mel on `stream` (one kernel).  `window` is the
// [n_fft] Hann window, `twiddles` the complex e^{-2 pi i j/n_fft} for j < n
// (n = n_fft/2 for an even n_fft, n_fft for an odd one), `mel_lo` /
// `mel_ptr` / `mel_w` the mel basis in CSR form.  Returns the CUDA error
// code (0 on success).  The caller checks that 1 <= n_fft <= 4096,
// hop | n_fft, win <= n_fft, num_mels >= 1, n_frames >= 1 and
// t_len > (n_fft - hop)/2.
int mel_spectrogram_launch(const float* y, const float* window, const float* twiddles,
                           const int* mel_lo, const int* mel_ptr, const float* mel_w,
                           float* out, int batch, int t_len, int n_frames, int n_fft,
                           int hop, int num_mels, void* stream) {
  if (n_fft < 1 || n_fft > MAX_N_FFT) return (int)cudaErrorInvalidValue;
  const int n = n_fft % 2 == 0 ? n_fft / 2 : n_fft;
  const auto tw = reinterpret_cast<const float2*>(twiddles);
  const auto s = (cudaStream_t)stream;
  return n >= 2 && (n & (n - 1)) == 0
             ? launch<true>(y, window, tw, mel_lo, mel_ptr, mel_w, out, batch, t_len, n_frames,
                            n_fft, hop, num_mels, n, s)
             : launch<false>(y, window, tw, mel_lo, mel_ptr, mel_w, out, batch, t_len,
                             n_frames, n_fft, hop, num_mels, n, s);
}

}  // extern "C"
