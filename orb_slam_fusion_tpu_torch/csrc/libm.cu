// Elementwise float32 math with the reference's bits, CUDA C++ for sm_90a.
//
// No Pallas counterpart: it restates the functions the reference's XLA:CPU
// programs compute (jax 0.9.0 on the AMD Zen 5 host that runs the parity
// tests), which CUDA's libdevice rounds its own way. One kernel, one
// function per launch, picked by a function id:
//
//   0 tan   glibc 2.36 tanf: a double pi/2 reduction, fdlibm's float32
//           __kernel_tanf, one rounding per operation;
//   1 exp   XLA:CPU's own expf polynomial, with LLVM's fused steps;
//   2 log   XLA:CPU's own logf polynomial, with LLVM's fused steps;
//   3 sin   glibc 2.36 sinf as built with FMA (__sinf_fma): double
//   4 cos   polynomials, every a + b * c one fused multiply-add;
//   5 atan2 glibc 2.36 atan2f (fdlibm), one rounding per operation;
//   6 fma   x * y + acc rounded once;
//   7 contract  per output a chain along the last axis of length k: the
//           product of element 0 plus a zero, then one fused step per
//           element (utils/fused.py::contract_f32);
//   8 octave_pow  1.2 ** k for the integers k = -16..16 (glibc's powf
//           there, a table), NaN for any other k.
//
// The reference runs with flush-to-zero and denormals-are-zero on, so a
// subnormal operand of its arithmetic reads as zero and a subnormal result
// is written as zero; flush() restates that where it can matter. NaN
// results carry the bits x86 gives them. Every step is written with an
// explicit rounding intrinsic, the file calls nothing of CUDA's math
// library, and it is compiled with -fmad=false, so nothing is fused that
// the reference did not fuse. The plain versions
// are the *_plain functions of orb_slam_fusion_tpu_torch/utils/libm.py and
// fused.py's fma_f32_plain / contract_f32; this kernel is held to them bit
// for bit (chip_smoke.py::check_libm, tests/test_torch_cuda.py).
//
// Operands are float32 of any strides, broadcast over at most MAX_DIMS
// dimensions (stride 0 where an operand broadcasts); the output is
// contiguous. A grid-stride loop, one element per thread per step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIMS = 6;

struct Meta {
  long long ndim;
  long long size[MAX_DIMS];
  long long stride[3][MAX_DIMS];   // operands a, b, c
  long long ka, kb;                // contract: strides along the last axis
};

__device__ __forceinline__ uint32_t bits_of(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ float from_bits(uint32_t b) {
  return __uint_as_float(b);
}
__device__ __forceinline__ float quiet(float x) {
  return from_bits(bits_of(x) | 0x00400000u);
}
// bit tests and the one rounding to an integer, written out so that no
// function of CUDA's math library (libdevice) is called
__device__ __forceinline__ bool is_nan(float x) {
  return (bits_of(x) & 0x7fffffffu) > 0x7f800000u;
}
__device__ __forceinline__ float abs_f(float x) {
  return from_bits(bits_of(x) & 0x7fffffffu);
}
__device__ __forceinline__ float floor_f(float x) {   // round down, exact
  float r;
  asm("cvt.rmi.f32.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float flush(float x) {
  const uint32_t b = bits_of(x);
  return (b & 0x7f800000u) == 0 ? from_bits(b & 0x80000000u) : x;
}
constexpr uint32_t DEFAULT_NAN = 0xffc00000u;   // x86's invalid-operation NaN

// ---- pi/2 reductions (glibc s_sincosf.h) ---------------------------------

__constant__ uint32_t INV_PIO4[24] = {
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
    0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
    0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
    0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
    0x95993c43, 0x993c4390, 0x3c439041};
constexpr double HPI_INV = 0x1.45f306dc9c883p+23;
constexpr double HPI = 0x1.921fb54442d18p+0;
constexpr double PI63 = 0x1.921fb54442d18p-62;

__device__ __forceinline__ int reduce_fast_n(double x) {
  const int r = __double2int_rz(__dmul_rn(x, HPI_INV));
  return (r + 0x800000) >> 24;
}

// x mod pi/2 of a float32 with |x| >= 120 (without its sign), quadrant n
__device__ double reduce_large(uint32_t xi, int* np) {
  const uint32_t* arr = &INV_PIO4[(xi >> 26) & 15];
  const int shift = (xi >> 23) & 7;
  xi = ((xi & 0x7fffffu) | 0x800000u) << shift;
  uint64_t res0 = static_cast<uint32_t>(xi * arr[0]);
  const uint64_t res1 = static_cast<uint64_t>(xi) * arr[4];
  const uint64_t res2 = static_cast<uint64_t>(xi) * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ull << 61)) >> 62;
  res0 -= n << 62;
  *np = static_cast<int>(n);
  return __dmul_rn(__ll2double_rn(static_cast<long long>(res0)), PI63);
}

// ---- sinf, cosf (glibc, FMA build) ---------------------------------------

struct SinCosTable {
  double c0, c1, s1, c2, s2, c3, s3, c4;
};
__constant__ SinCosTable SC[2] = {
    {1.0, -0x1.ffffffd0c621cp-2, -0x1.555545995a603p-3, 0x1.55553e1068f19p-5,
     0x1.1107605230bc4p-7, -0x1.6c087e89a359dp-10, -0x1.994eb3774cf24p-13,
     0x1.99343027bf8c3p-16},
    {-1.0, 0x1.ffffffd0c621cp-2, -0x1.555545995a603p-3, -0x1.55553e1068f19p-5,
     0x1.1107605230bc4p-7, 0x1.6c087e89a359dp-10, -0x1.994eb3774cf24p-13,
     -0x1.99343027bf8c3p-16}};
__constant__ double SC_SIGN[4] = {1.0, -1.0, -1.0, 1.0};

__device__ float sincos_poly(double x, double x2, const SinCosTable& p,
                             int n) {
  if ((n & 1) == 0) {
    const double x3 = __dmul_rn(x2, x);
    const double s1 = __fma_rn(x2, p.s3, p.s2);
    const double x7 = __dmul_rn(x2, x3);
    const double s = __fma_rn(x3, p.s1, x);
    return __double2float_rn(__fma_rn(s1, x7, s));
  }
  const double x4 = __dmul_rn(x2, x2);
  const double c1 = __fma_rn(x2, p.c1, p.c0);
  const double c2 = __fma_rn(x2, p.c4, p.c3);
  const double x6 = __dmul_rn(x2, x4);
  const double c = __fma_rn(x4, p.c2, c1);
  return __double2float_rn(__fma_rn(c2, x6, c));
}

__device__ float sincosf_ref(float y, int cosine) {
  const uint32_t b = bits_of(y);
  const uint32_t top = (b >> 20) & 0x7ff;
  if (top >= 0x7f8) return is_nan(y) ? quiet(y) : from_bits(DEFAULT_NAN);
  const double x = static_cast<double>(y);
  if (top < 0x3f4) {                               // |y| < pi/4 (roughly)
    if (top < 0x398) return cosine ? 1.0f : y;     // |y| < 2^-12
    return sincos_poly(x, __dmul_rn(x, x), SC[0], cosine);
  }
  if (top < 0x42f) {                               // |y| < 120
    const int n = reduce_fast_n(x);
    const double xr = __fma_rn(-static_cast<double>(n), HPI, x);
    return sincos_poly(__dmul_rn(xr, SC_SIGN[n & 3]), __dmul_rn(xr, xr),
                       SC[(n & 2) ? 1 : 0], n ^ cosine);
  }
  int n;
  const double xr = reduce_large(b, &n);
  const int q = n + static_cast<int>(b >> 31);
  return sincos_poly(__dmul_rn(xr, SC_SIGN[q & 3]), __dmul_rn(xr, xr),
                     SC[(q & 2) ? 1 : 0], n ^ cosine);
}

// ---- tanf (glibc s_tanf.c, fdlibm k_tanf.c) --------------------------------

__constant__ float TT[13] = {
    0x1.555556p-2f, 0x1.111112p-3f, 0x1.ba1ba2p-5f, 0x1.664f48p-6f,
    0x1.226e3ep-7f, 0x1.d6d22cp-9f, 0x1.7dbc90p-10f, 0x1.344d90p-11f,
    0x1.026f72p-12f, 0x1.47e88ap-14f, 0x1.2b80f4p-14f, -0x1.375cbep-16f,
    0x1.b2a708p-16f};
constexpr float PIO4 = 0x1.921fb4p-1f;             // 0x3f490fda
constexpr float PIO4LO = 0x1.4442d0p-25f;          // 0x33222168

__device__ float kernel_tanf(float x, float y, int iy) {
  const uint32_t hx = bits_of(x);
  const uint32_t ix = hx & 0x7fffffffu;
  if (ix < 0x39000000u) {                          // |x| < 2^-13
    if (iy == 1) return x;
    if (ix == 0) return __fdiv_rn(1.0f, abs_f(x));
    return __fdiv_rn(-1.0f, x);
  }
  const bool big = ix >= 0x3f2ca140u;              // |x| >= 0.6744
  const float sgn = (hx >> 31) ? -1.0f : 1.0f;
  const float fiy = static_cast<float>(iy);
  if (big) {
    if (hx >> 31) {
      x = -x;
      y = -y;
    }
    x = __fadd_rn(__fsub_rn(PIO4, x), __fsub_rn(PIO4LO, y));
    y = 0.0f;
    if (abs_f(x) < 0x1p-13f)
      return __fmul_rn(__fmul_rn(sgn, fiy),
                       __fsub_rn(1.0f, __fmul_rn(__fadd_rn(fiy, fiy), x)));
  }
  const float z = __fmul_rn(x, x);
  const float w = __fmul_rn(z, z);
  float r = TT[11];
  for (int k = 9; k >= 1; k -= 2) r = __fadd_rn(__fmul_rn(r, w), TT[k]);
  float v = TT[12];
  for (int k = 10; k >= 2; k -= 2) v = __fadd_rn(__fmul_rn(v, w), TT[k]);
  v = __fmul_rn(v, z);
  const float s = __fmul_rn(z, x);
  r = __fadd_rn(y, __fmul_rn(z, __fadd_rn(__fmul_rn(s, __fadd_rn(r, v)), y)));
  r = __fadd_rn(__fmul_rn(s, TT[0]), r);
  const float wv = __fadd_rn(x, r);
  if (big) {
    const float q = __fsub_rn(__fdiv_rn(__fmul_rn(wv, wv), __fadd_rn(wv, fiy)),
                              r);
    return __fmul_rn(sgn, __fsub_rn(fiy, __fmul_rn(__fsub_rn(x, q), 2.0f)));
  }
  if (iy == 1) return wv;
  // -1/(x + r) with the quotient's error recovered
  const float a = __fdiv_rn(-1.0f, wv);
  const float zt = from_bits(bits_of(wv) & 0xfffff000u);
  const float vt = __fsub_rn(r, __fsub_rn(zt, x));
  const float t = from_bits(bits_of(a) & 0xfffff000u);
  const float sm = __fadd_rn(__fmul_rn(t, zt), 1.0f);
  return __fadd_rn(t, __fmul_rn(a, __fadd_rn(__fmul_rn(t, vt), sm)));
}

__device__ float tanf_ref(float x) {
  const uint32_t b = bits_of(x);
  const uint32_t ix = b & 0x7fffffffu;
  if (ix >= 0x7f800000u) return is_nan(x) ? quiet(x) : from_bits(DEFAULT_NAN);
  if (ix <= 0x3f490fdau) return kernel_tanf(x, 0.0f, 1);
  double xr;
  int n;
  if (((b >> 20) & 0x7ff) < 0x42f) {               // |x| < 120
    const double xd = static_cast<double>(x);
    n = reduce_fast_n(xd);
    xr = __dsub_rn(xd, __dmul_rn(static_cast<double>(n), HPI));
  } else {
    xr = reduce_large(b, &n);
    if (b >> 31) xr = -xr;
  }
  const float y0 = __double2float_rn(xr);
  const float y1 = __double2float_rn(__dsub_rn(xr, static_cast<double>(y0)));
  return kernel_tanf(y0, y1, 1 - ((n & 1) << 1));
}

// ---- atan2f (glibc e_atan2f.c, s_atanf.c) ----------------------------------

__constant__ float ATANHI[4] = {0x1.dac670p-2f, 0x1.921fb4p-1f,
                                0x1.f730bcp-1f, 0x1.921fb4p+0f};
__constant__ float ATANLO[4] = {0x1.586ed2p-28f, 0x1.4442d0p-25f,
                                0x1.281f68p-25f, 0x1.4442d0p-24f};
__constant__ float AT[11] = {
    0x1.555556p-2f, -0x1.99999ap-3f, 0x1.24924ap-3f, -0x1.c71c70p-4f,
    0x1.745cdcp-4f, -0x1.3b0f2ap-4f, 0x1.10d66ap-4f, -0x1.dde2d6p-5f,
    0x1.97b4b2p-5f, -0x1.2b4442p-5f, 0x1.0ad3aep-6f};
constexpr float PI_F = 0x1.921fb6p+1f;             // 0x40490fdb
constexpr float PI_LO = -0x1.777a5cp-24f;          // 0xb3bbbd2e
constexpr float PI_O_2 = 0x1.921fb6p+0f;           // 0x3fc90fdb
constexpr float PI_O_4 = 0x1.921fb6p-1f;           // 0x3f490fdb

__device__ float atanf_pos(float t) {
  const uint32_t it = bits_of(t);
  if (it >= 0x4c000000u) return __fadd_rn(ATANHI[3], ATANLO[3]);
  if (it < 0x31000000u) return t;                  // t < 2^-29
  const bool small = it < 0x3ee00000u;             // t < 7/16
  int id = 0;
  float x = t;
  if (!small) {
    if (it < 0x3f300000u) {
      id = 0;
      x = __fdiv_rn(__fsub_rn(__fmul_rn(t, 2.0f), 1.0f), __fadd_rn(t, 2.0f));
    } else if (it < 0x3f980000u) {
      id = 1;
      x = __fdiv_rn(__fsub_rn(t, 1.0f), __fadd_rn(t, 1.0f));
    } else if (it < 0x401c0000u) {
      id = 2;
      x = __fdiv_rn(__fsub_rn(t, 1.5f), __fadd_rn(1.0f, __fmul_rn(t, 1.5f)));
    } else {
      id = 3;
      x = __fdiv_rn(-1.0f, t);
    }
  }
  const float z = __fmul_rn(x, x);
  const float w = __fmul_rn(z, z);
  float a = AT[10];
  for (int k = 8; k >= 0; k -= 2) a = __fadd_rn(__fmul_rn(w, a), AT[k]);
  float bb = AT[9];
  for (int k = 7; k >= 1; k -= 2) bb = __fadd_rn(__fmul_rn(w, bb), AT[k]);
  const float s = __fadd_rn(__fmul_rn(z, a), __fmul_rn(w, bb));
  if (small) return __fsub_rn(x, __fmul_rn(x, s));
  return __fsub_rn(ATANHI[id],
                   __fsub_rn(__fsub_rn(__fmul_rn(x, s), ATANLO[id]), x));
}

__device__ float atan2f_ref(float y, float x) {
  const uint32_t hx = bits_of(x), hy = bits_of(y);
  const uint32_t ix = hx & 0x7fffffffu, iy = hy & 0x7fffffffu;
  if (is_nan(x)) return quiet(x);
  if (is_nan(y)) return quiet(y);
  const bool neg_x = hx >> 31, neg_y = hy >> 31;
  if (hx == 0x3f800000u) {                         // x = 1: atanf(y)
    const float a = atanf_pos(abs_f(y));
    return neg_y ? -a : a;
  }
  const float half_pi = neg_y ? -PI_O_2 : PI_O_2;
  if (iy == 0) return neg_x ? (neg_y ? -PI_F : PI_F) : y;
  if (ix == 0) return half_pi;
  if (ix == 0x7f800000u) {
    const float a = iy == 0x7f800000u
                        ? (neg_x ? __fmul_rn(3.0f, PI_O_4) : PI_O_4)
                        : (neg_x ? PI_F : 0.0f);
    return neg_y ? -a : a;
  }
  if (iy == 0x7f800000u) return half_pi;
  const int k = (static_cast<int>(iy) - static_cast<int>(ix)) >> 23;
  const float q = flush(__fdiv_rn(flush(y), flush(x)));
  float z;
  if (k > 60)
    z = __fadd_rn(PI_O_2, __fmul_rn(0.5f, PI_LO));
  else if (neg_x && k < -60)
    z = 0.0f;
  else
    z = is_nan(q) ? from_bits(0x7fc00000u) : atanf_pos(abs_f(q));
  // a NaN z keeps its bits but for case 1's sign flip (a bit operation:
  // negation is free to change a NaN's bits)
  if (is_nan(z))
    return (neg_y && !neg_x) ? from_bits(bits_of(z) ^ 0x80000000u) : z;
  if (!neg_x) return neg_y ? -z : z;
  return neg_y ? __fsub_rn(__fsub_rn(z, PI_LO), PI_F)
               : __fsub_rn(PI_F, __fsub_rn(z, PI_LO));
}

// ---- expf, logf (XLA:CPU's own, fused as LLVM compiles them on Zen 5) ----

__device__ float expf_ref(float x) {
  if (is_nan(x)) return quiet(x);
  float xc = x < -0x1.5f3334p+6f ? -0x1.5f3334p+6f : x;     // -87.8
  xc = xc > 0x1.633334p+6f ? 0x1.633334p+6f : xc;           // 88.8
  float fx = floor_f(__fmaf_rn(xc, 0x1.715476p+0f, 0.5f));   // log2(e)
  fx = fx < -127.0f ? -127.0f : fx;
  fx = fx > 127.0f ? 127.0f : fx;
  float r = __fmaf_rn(-fx, 0x1.630000p-1f, xc);             // ln2 hi
  r = __fmaf_rn(-fx, -0x1.bd0106p-13f, r);                  // ln2 lo
  float p = __fmaf_rn(r, 0x1.a0d2cep-13f, 0x1.6e879cp-10f);
  p = __fmaf_rn(p, r, 0x1.111210p-7f);
  p = __fmaf_rn(p, r, 0x1.555382p-5f);
  p = __fmaf_rn(p, r, 0x1.555554p-3f);
  p = __fmaf_rn(p, r, 0.5f);
  const float yv = __fadd_rn(__fmaf_rn(p, __fmul_rn(r, r), r), 1.0f);
  const int n = __float2int_rz(fx);
  return flush(__fmul_rn(
      yv, from_bits((static_cast<uint32_t>(n) << 23) + 0x3f800000u)));
}

__device__ float logf_ref(float x) {
  x = flush(x);
  if (x == 0.0f) return from_bits(0xff800000u);             // -inf
  if (!(x > 0.0f)) return from_bits(0xffffffffu);           // x < 0, NaN
  if (bits_of(x) == 0x7f800000u) return x;                  // +inf
  const uint32_t cb = bits_of(x);
  float e = __fadd_rn(__int2float_rn(static_cast<int>(cb >> 23) - 127), 1.0f);
  const float m = from_bits((cb & 0x807fffffu) | 0x3f000000u);
  const bool lt = m < 0x1.6a09e6p-1f;                       // sqrt(1/2)
  if (lt) e = __fsub_rn(e, 1.0f);
  const float v = __fadd_rn(__fsub_rn(m, 1.0f), lt ? m : 0.0f);
  const float z = __fmul_rn(v, v);
  const float v3 = __fmul_rn(z, v);
  float y1 = __fmaf_rn(v, 0x1.204376p-4f, -0x1.d7a370p-4f);
  float y2 = __fmaf_rn(v, -0x1.fcba9ep-4f, 0x1.23d37ep-3f);
  float y3 = __fmaf_rn(v, 0x1.999d58p-3f, -0x1.fffff8p-3f);
  y1 = __fmaf_rn(y1, v, 0x1.de4a34p-4f);
  y2 = __fmaf_rn(y2, v, -0x1.555ca0p-3f);
  y3 = __fmaf_rn(y3, v, 0x1.555554p-2f);
  float yv = __fmaf_rn(y1, v3, y2);
  yv = __fmaf_rn(yv, v3, y3);
  yv = __fmaf_rn(yv, v3, __fmul_rn(e, -0x1.bd0106p-13f));
  const float out = __fadd_rn(__fmaf_rn(z, -0.5f, v), yv);
  return __fmaf_rn(e, 0x1.630000p-1f, out);
}

// ---- 1.2 ** k ---------------------------------------------------------------

__constant__ uint32_t OCTAVE_POW[33] = {
    0x3D5D8B3B, 0x3D84ED24, 0x3D9F82F8, 0x3DBF69F7, 0x3DE5B25C, 0x3E09D16B,
    0x3E2561B4, 0x3E46753F, 0x3E6E264C, 0x3E8EE3C8, 0x3EAB77BD, 0x3ECDC2E3,
    0x3EF6E9DE, 0x3F1425EC, 0x3F31C71C, 0x3F555555, 0x3F800000, 0x3F99999A,
    0x3FB851EC, 0x3FDD2F1C, 0x4004B5DE, 0x401F40A5, 0x403F1A60, 0x406552DA,
    0x4089981D, 0x40A51CF0, 0x40C622BA, 0x40EDC346, 0x410EA85D, 0x412B3071,
    0x414D6D54, 0x41768333, 0x4193E852};

__device__ float octave_pow_ref(float k) {
  if (!(k >= -16.0f && k <= 16.0f) || k != floor_f(k))
    return from_bits(0x7fc00000u);
  return from_bits(OCTAVE_POW[__float2int_rz(k) + 16]);
}

// ---- the kernel ------------------------------------------------------------

__global__ void libm_kernel(int fid, const float* __restrict__ a,
                            const float* __restrict__ b,
                            const float* __restrict__ c,
                            float* __restrict__ out, long long n, int k,
                            Meta meta) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long oa = 0, ob = 0, oc = 0;
    if (meta.ndim == 1) {                  // no division for one dimension
      oa = i * meta.stride[0][0];
      ob = i * meta.stride[1][0];
      oc = i * meta.stride[2][0];
    } else {
      long long rest = i;
      for (int d = static_cast<int>(meta.ndim) - 1; d >= 0; --d) {
        const long long coord = rest % meta.size[d];
        rest /= meta.size[d];
        oa += coord * meta.stride[0][d];
        ob += coord * meta.stride[1][d];
        oc += coord * meta.stride[2][d];
      }
    }
    float r;
    switch (fid) {
      case 0: r = tanf_ref(a[oa]); break;
      case 1: r = expf_ref(a[oa]); break;
      case 2: r = logf_ref(a[oa]); break;
      case 3: r = sincosf_ref(a[oa], 0); break;
      case 4: r = sincosf_ref(a[oa], 1); break;
      case 5: r = atan2f_ref(a[oa], b[ob]); break;
      case 6: r = __fmaf_rn(a[oa], b[ob], c[oc]); break;
      case 8: r = octave_pow_ref(a[oa]); break;
      default: {                                    // 7: contract
        r = __fadd_rn(__fmul_rn(a[oa], b[ob]), c[oc]);
        for (int j = 1; j < k; ++j)
          r = __fmaf_rn(a[oa + j * meta.ka], b[ob + j * meta.kb], r);
      }
    }
    out[i] = r;
  }
}

}  // namespace

// fid: the function (see the top); a, b, c: operands (b and c unused by the
// unary functions); out: n contiguous results; k: contract's chain length;
// meta_host: host array of 1 + 4 * MAX_DIMS + 2 int64 (ndim, sizes, the
// three operands' strides, contract's two last-axis strides).
extern "C" int osf_libm(int fid, const void* a, const void* b, const void* c,
                        void* out, long long n, int k, const void* meta_host,
                        void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (fid < 0 || fid > 8) return static_cast<int>(cudaErrorInvalidValue);
  const long long* m = static_cast<const long long*>(meta_host);
  Meta meta;
  meta.ndim = m[0];
  if (meta.ndim < 0 || meta.ndim > MAX_DIMS)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < MAX_DIMS; ++d) {
    meta.size[d] = m[1 + d];
    for (int o = 0; o < 3; ++o) meta.stride[o][d] = m[1 + MAX_DIMS * (o + 1) + d];
  }
  meta.ka = m[1 + 4 * MAX_DIMS];
  meta.kb = m[2 + 4 * MAX_DIMS];
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  libm_kernel<<<static_cast<int>(blocks), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      fid, static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(out), n, k, meta);
  return static_cast<int>(cudaGetLastError());
}
