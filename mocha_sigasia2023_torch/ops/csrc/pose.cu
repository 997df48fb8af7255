// The frame step's pose math, two launches a step: pose_roots (the three
// root integrations and the assembled poses) and pose_ik (the two blends,
// foot locking and two-bone IK of both legs).
//
// Replaces no TPU kernel: the JAX package leaves this math to XLA, which
// fuses it into the step's program.  The port's eager form
// (runtime/stream.py: _integrate_root, _guarded_ratio, _set_root,
// _assemble, _ik_fixup; kinematics/quat.py, kinematics/inertial.py) is one
// PyTorch launch an operation, about 1,300 a step, each on a few KB; the
// host's dispatch of them, not the card, set the step's time.
//
// What bounds it on an H100: neither bytes nor operations.  At S = 256
// streams a step reads and writes a few hundred KB (microseconds at
// 3.35 TB/s), and the arithmetic is a few thousand operations a stream.
// The latency of one stream's dependent chain (FK down a leg, the contact
// spring, the IK's square roots, divisions and arccos, in float64 for the
// offline sessions) bounds it.  So the design keeps the launches few and
// the host's work small: one warp a stream, four streams a block.
//   * pose_roots: lanes 0, 1 and 2 integrate the source, CVAE-stream and
//     NN-stream roots at once; then every lane copies the joint rows
//     (rows 1..J-1) of the four source and five decoded pose tensors,
//     with each root row cast to float32 at row 0.
//   * pose_ik: every lane takes both blends of its elements; lane l < 2
//     runs leg l alone: FK down the chain root -> toe (the joints the IK
//     reads; each joint's global rotation and position by quat.fk's own
//     arithmetic, parent before child), the contact state machine of the
//     leg's toe, and the two-bone solve, then writes the hip and knee rows.
//
// Numerics: the same work as the eager code, not an approximation.  Each
// PyTorch operation rounds its result once, in the dtype of its operands
// after promotion (float32 x float64 -> float64), and so does each operation
// here: a value of a tensor of dtype T is an N<T>, whose operators round
// through __f*_rn / __d*_rn intrinsics, which the compiler never contracts
// into an FMA.  A Python float meets a tensor in the tensor's dtype; a
// tensor divided by a Python float is multiplied by the float's reciprocal
// (taken in double, rounded to the tensor's dtype), as PyTorch's CUDA
// division does; a sum over the last
// axis of 3 adds (x0 + x2) + x1, the order of PyTorch's CUDA reduction for
// three elements; sinc is PyTorch's (sin(pi x) / (pi x), 1 at 0); cos, sin
// and arccos are libdevice's, as PyTorch's kernels call them.  The eps
// constants are the eager functions' defaults (normalize 1e-8 over a 1e-30
// floor, exp 1e-5, contact_update 1e-8).  The root integrators and contact
// springs run in R (float or double, the carry's dtype), everything else
// in float32, with promotions where the eager code promotes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // streams a block, a warp each
constexpr int kMaxChain = 32;      // joints from the root to a toe, at most
constexpr double kPi = 3.14159265358979323846;

// ---- numbers rounded one operation at a time --------------------------

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float cos_(float a) { return ::cosf(a); }
__device__ __forceinline__ double cos_(double a) { return ::cos(a); }
__device__ __forceinline__ float sin_(float a) { return ::sinf(a); }
__device__ __forceinline__ double sin_(double a) { return ::sin(a); }
__device__ __forceinline__ float acos_(float a) { return ::acosf(a); }
__device__ __forceinline__ double acos_(double a) { return ::acos(a); }

template <class A, class B> struct Promote { using T = double; };
template <> struct Promote<float, float> { using T = float; };
template <class A, class B> using P = typename Promote<A, B>::T;

// One element of a tensor of dtype T.
template <class T> struct N { T v; };

#define MOCHA_BINARY(OP, FN)                                                  \
  template <class A, class B>                                                 \
  __device__ __forceinline__ N<P<A, B>> operator OP(N<A> a, N<B> b) {         \
    return {FN((P<A, B>)a.v, (P<A, B>)b.v)};                                  \
  }                                                                           \
  template <class A>                                                          \
  __device__ __forceinline__ N<A> operator OP(N<A> a, double s) {             \
    return {FN(a.v, (A)s)};                                                   \
  }                                                                           \
  template <class A>                                                          \
  __device__ __forceinline__ N<A> operator OP(double s, N<A> a) {             \
    return {FN((A)s, a.v)};                                                   \
  }
MOCHA_BINARY(+, add_rn)
MOCHA_BINARY(-, sub_rn)
MOCHA_BINARY(*, mul_rn)
#undef MOCHA_BINARY

template <class A, class B>
__device__ __forceinline__ N<P<A, B>> operator/(N<A> a, N<B> b) {
  return {div_rn((P<A, B>)a.v, (P<A, B>)b.v)};
}
// a tensor over a Python float: times the float's reciprocal, taken in
// double and rounded to A
template <class A>
__device__ __forceinline__ N<A> operator/(N<A> a, double s) {
  return {mul_rn(a.v, (A)div_rn(1.0, s))};
}
template <class A> __device__ __forceinline__ N<A> operator-(N<A> a) {
  return {-a.v};
}
template <class A, class B>
__device__ __forceinline__ bool operator>(N<A> a, N<B> b) {
  return (P<A, B>)a.v > (P<A, B>)b.v;
}
template <class A> __device__ __forceinline__ bool operator>(N<A> a, double s) {
  return a.v > (A)s;
}
template <class A> __device__ __forceinline__ bool operator<(N<A> a, double s) {
  return a.v < (A)s;
}
template <class A> __device__ __forceinline__ N<A> num(double s) {
  return {(A)s};
}
template <class T, class A> __device__ __forceinline__ N<T> to(N<A> a) {
  return {(T)a.v};
}
template <class A> __device__ __forceinline__ N<A> sqrt(N<A> a) {
  return {sqrt_rn(a.v)};
}
template <class A> __device__ __forceinline__ N<A> cos(N<A> a) {
  return {cos_(a.v)};
}
template <class A> __device__ __forceinline__ N<A> sin(N<A> a) {
  return {sin_(a.v)};
}
template <class A> __device__ __forceinline__ N<A> arccos(N<A> a) {
  return {acos_(a.v)};
}
// torch.clamp / clamp_min: NaN passes through
template <class A>
__device__ __forceinline__ N<A> clamp(N<A> x, double lo, double hi) {
  if (isnan(x.v)) return x;
  return {fmin(fmax(x.v, (A)lo), (A)hi)};
}
template <class A>
__device__ __forceinline__ N<A> clamp_min(N<A> x, double lo) {
  if (isnan(x.v)) return x;
  return {fmax(x.v, (A)lo)};
}
// torch.sinc on the card
template <class A> __device__ __forceinline__ N<A> sinc(N<A> a) {
  if (a.v == (A)0) return {(A)1};
  const N<A> x = num<A>(kPi) * a;
  return sin(x) / x;
}
template <class A>
__device__ __forceinline__ N<A> where(bool c, N<A> a, N<A> b) {
  return c ? a : b;
}

// ---- vectors (x, y, z) and quaternions (w, x, y, z) ------------------

template <class T> struct V3 { N<T> x, y, z; };
template <class T> struct Q4 { N<T> w, x, y, z; };

template <class A, class B>
__device__ __forceinline__ V3<P<A, B>> operator+(V3<A> a, V3<B> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <class A, class B>
__device__ __forceinline__ V3<P<A, B>> operator-(V3<A> a, V3<B> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <class A, class B>
__device__ __forceinline__ V3<P<A, B>> operator*(V3<A> a, V3<B> b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
template <class A, class B>
__device__ __forceinline__ V3<P<A, B>> operator*(N<A> s, V3<B> v) {
  return {s * v.x, s * v.y, s * v.z};
}
template <class A, class B>
__device__ __forceinline__ V3<P<A, B>> operator*(V3<A> v, N<B> s) {
  return {v.x * s, v.y * s, v.z * s};
}
template <class A, class B>
__device__ __forceinline__ V3<P<A, B>> operator/(V3<A> v, N<B> s) {
  return {v.x / s, v.y / s, v.z / s};
}
template <class A>
__device__ __forceinline__ V3<A> operator*(V3<A> v, double s) {
  return {v.x * s, v.y * s, v.z * s};
}
template <class A>
__device__ __forceinline__ V3<A> operator*(double s, V3<A> v) {
  return {s * v.x, s * v.y, s * v.z};
}
template <class A>
__device__ __forceinline__ V3<A> operator/(V3<A> v, double s) {
  return {v.x / s, v.y / s, v.z / s};
}
template <class T, class A> __device__ __forceinline__ V3<T> to(V3<A> v) {
  return {to<T>(v.x), to<T>(v.y), to<T>(v.z)};
}
template <class T, class A> __device__ __forceinline__ Q4<T> to(Q4<A> q) {
  return {to<T>(q.w), to<T>(q.x), to<T>(q.y), to<T>(q.z)};
}
template <class A>
__device__ __forceinline__ V3<A> where(bool c, V3<A> a, V3<A> b) {
  return c ? a : b;
}

// torch.sum over a last axis of 3 on the card: (x0 + x2) + x1
template <class A> __device__ __forceinline__ N<A> sum3(V3<A> v) {
  return (v.x + v.z) + v.y;
}
template <class A, class B>
__device__ __forceinline__ N<P<A, B>> dot(V3<A> a, V3<B> b) {
  return sum3(a * b);
}
template <class A> __device__ __forceinline__ N<A> length(V3<A> v) {
  return sqrt(sum3(v * v));
}
// quat.normalize: x / (safe_sqrt(sum(x * x), 1e-30) + 1e-8)
template <class A> __device__ __forceinline__ V3<A> normalize(V3<A> v) {
  return v / (sqrt(clamp_min(sum3(v * v), 1e-30)) + 1e-8);
}
template <class A, class B>
__device__ __forceinline__ V3<P<A, B>> cross(V3<A> a, V3<B> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
template <class A> __device__ __forceinline__ V3<A> imag(Q4<A> q) {
  return {q.x, q.y, q.z};
}
// quat.mul_vec: v + w * t + cross(q_xyz, t), t = 2 * cross(q_xyz, v)
template <class A, class B>
__device__ __forceinline__ V3<P<A, B>> mul_vec(Q4<A> q, V3<B> v) {
  const auto t = 2.0 * cross(imag(q), v);
  return v + q.w * t + cross(imag(q), t);
}
// quat.mul(x, y), the Hamilton product x * y
template <class A, class B>
__device__ __forceinline__ Q4<P<A, B>> mul(Q4<A> x, Q4<B> y) {
  return {y.w * x.w - y.x * x.x - y.y * x.y - y.z * x.z,
          y.w * x.x + y.x * x.w - y.y * x.z + y.z * x.y,
          y.w * x.y + y.x * x.z + y.y * x.w - y.z * x.x,
          y.w * x.z - y.x * x.y + y.y * x.x + y.z * x.w};
}
template <class A> __device__ __forceinline__ Q4<A> inv(Q4<A> q) {
  return {q.w, -q.x, -q.y, -q.z};
}
template <class A, class B>
__device__ __forceinline__ Q4<P<A, B>> inv_mul(Q4<A> x, Q4<B> y) {
  return mul(inv(x), y);
}
// quat.from_angle_axis
template <class A, class B>
__device__ __forceinline__ Q4<P<A, B>> from_angle_axis(N<A> angle, V3<B> axis) {
  const N<A> c = cos(angle / 2.0);
  const N<A> s = sin(angle / 2.0);
  const V3<P<A, B>> v = s * axis;
  return {to<P<A, B>>(c), v.x, v.y, v.z};
}
// quat.from_scaled_angle_axis = quat.exp(v / 2)
template <class A>
__device__ __forceinline__ Q4<A> from_scaled_angle_axis(V3<A> scaled) {
  const V3<A> v = scaled / 2.0;
  const N<A> half = sqrt(clamp_min(sum3(v * v), 1e-30));
  const bool small = half < 1e-5;
  const N<A> c = where(small, num<A>(1.0), cos(half));
  const N<A> s = where(small, num<A>(1.0), sinc(half / kPi));
  return {c, s * v.x, s * v.y, s * v.z};
}

// ---- tensors ---------------------------------------------------------

// A (S, ...) tensor: element (s, j, e) at p + s * s_stride + j * j_stride +
// e * e_stride elements ((S,) and (S, k) tensors take j = 0).
struct View {
  const void* p;
  long long s, j, e;
};

template <class T>
__device__ __forceinline__ N<T> ld(const View& v, int s, int j, int e) {
  return {static_cast<const T*>(v.p)[s * v.s + j * v.j + e * v.e]};
}
template <class T>
__device__ __forceinline__ V3<T> ld3(const View& v, int s, int j) {
  return {ld<T>(v, s, j, 0), ld<T>(v, s, j, 1), ld<T>(v, s, j, 2)};
}
template <class T>
__device__ __forceinline__ Q4<T> ld4(const View& v, int s, int j) {
  return {ld<T>(v, s, j, 0), ld<T>(v, s, j, 1), ld<T>(v, s, j, 2),
          ld<T>(v, s, j, 3)};
}
// a bool of an (S, 2) tensor
__device__ __forceinline__ bool flag(const View& v, int s, int leg) {
  return static_cast<const uint8_t*>(v.p)[s * v.s + leg * v.e] != 0;
}
// outputs are contiguous
template <class T>
__device__ __forceinline__ void st3(void* p, long long row, V3<T> v) {
  T* o = static_cast<T*>(p) + row * 3;
  o[0] = v.x.v; o[1] = v.y.v; o[2] = v.z.v;
}
template <class T>
__device__ __forceinline__ void st4(void* p, long long row, Q4<T> q) {
  T* o = static_cast<T*>(p) + row * 4;
  o[0] = q.w.v; o[1] = q.x.v; o[2] = q.y.v; o[3] = q.z.v;
}

// ---- pose_roots -------------------------------------------------------

struct RootsArgs {
  // inputs: the root carries (R), the frame's source rows (float32), the
  // decoded CVAE-stream (t_) and NN-stream (c_) rows (float32, J - 1 rows)
  View src_pos0, src_rot0, trans_pos0, trans_rot0, cm_pos0, cm_rot0;
  View rvel, rang, pos_last, rot_last, vel_last, ang_last, hips_speed;
  View t_pos, t_rot, t_vel, t_speed, c_pos, c_rot, c_speed;
  // outputs: (S, J, 3|4) float32 poses, (S, 3|4) R carries
  void *src_pos, *src_rot, *src_vel, *src_ang, *trans_pos, *trans_rot,
      *trans_vel, *cm_pos, *cm_rot;
  void *new_src_pos0, *new_src_rot0, *new_trans_pos0, *new_trans_rot0,
      *new_cm_pos0, *new_cm_rot0;
  double dt;
  int S, J;
};

// _guarded_ratio: pred / src, 1 outside [0.33, 3] or non-finite
__device__ __forceinline__ N<float> guarded_ratio(N<float> pred, N<float> src) {
  const N<float> ratio = pred / src;
  const bool bad = ratio > 3.0 || ratio < 0.33 || !isfinite(ratio.v);
  return where(bad, num<float>(1.0), ratio);
}

template <class R>
__global__ void __launch_bounds__(kWarps * 32) pose_roots(const RootsArgs a) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= a.S) return;
  const int J = a.J;
  const long long row0 = (long long)s * J;
  if (lane < 3) {
    // lane 0 the source root, 1 the CVAE stream's, 2 the NN stream's
    V3<float> rvel = ld3<float>(a.rvel, s, 0);
    if (lane > 0)
      rvel = rvel * guarded_ratio(
          ld<float>(lane == 1 ? a.t_speed : a.c_speed, s, 0, 0),
          ld<float>(a.hips_speed, s, 0, 0));
    const View pos0 =
        lane == 0 ? a.src_pos0 : lane == 1 ? a.trans_pos0 : a.cm_pos0;
    const View rot0 =
        lane == 0 ? a.src_rot0 : lane == 1 ? a.trans_rot0 : a.cm_rot0;
    const Q4<R> q0 = ld4<R>(rot0, s, 0);
    // _integrate_root
    const V3<R> rootvel = mul_vec(q0, rvel);
    const V3<R> rootang = mul_vec(q0, ld3<float>(a.rang, s, 0));
    const V3<R> rootpos = ld3<R>(pos0, s, 0) + rootvel * a.dt;
    const Q4<R> rootrot = mul(q0, from_scaled_angle_axis(rootang * a.dt));
    st3(lane == 0   ? a.new_src_pos0
        : lane == 1 ? a.new_trans_pos0
                    : a.new_cm_pos0,
        s, rootpos);
    st4(lane == 0   ? a.new_src_rot0
        : lane == 1 ? a.new_trans_rot0
                    : a.new_cm_rot0,
        s, rootrot);
    // _set_root / _assemble: the root row in float32
    st3(lane == 0 ? a.src_pos : lane == 1 ? a.trans_pos : a.cm_pos, row0,
        to<float>(rootpos));
    st4(lane == 0 ? a.src_rot : lane == 1 ? a.trans_rot : a.cm_rot, row0,
        to<float>(rootrot));
    if (lane < 2)
      st3(lane == 0 ? a.src_vel : a.trans_vel, row0, to<float>(rootvel));
    if (lane == 0) st3(a.src_ang, row0, to<float>(rootang));
  }
  // rows 1..J-1: the source's own, and the decoded rows shifted by one
  for (int e = lane; e < (J - 1) * 3; e += 32) {
    const int j = 1 + e / 3, k = e % 3;
    const long long o = (row0 + j) * 3 + k;
    static_cast<float*>(a.src_pos)[o] = ld<float>(a.pos_last, s, j, k).v;
    static_cast<float*>(a.src_vel)[o] = ld<float>(a.vel_last, s, j, k).v;
    static_cast<float*>(a.src_ang)[o] = ld<float>(a.ang_last, s, j, k).v;
    static_cast<float*>(a.trans_pos)[o] = ld<float>(a.t_pos, s, j - 1, k).v;
    static_cast<float*>(a.trans_vel)[o] = ld<float>(a.t_vel, s, j - 1, k).v;
    static_cast<float*>(a.cm_pos)[o] = ld<float>(a.c_pos, s, j - 1, k).v;
  }
  for (int e = lane; e < (J - 1) * 4; e += 32) {
    const int j = 1 + e / 4, k = e % 4;
    const long long o = (row0 + j) * 4 + k;
    static_cast<float*>(a.src_rot)[o] = ld<float>(a.rot_last, s, j, k).v;
    static_cast<float*>(a.trans_rot)[o] = ld<float>(a.t_rot, s, j - 1, k).v;
    static_cast<float*>(a.cm_rot)[o] = ld<float>(a.c_rot, s, j - 1, k).v;
  }
}

// ---- pose_ik ----------------------------------------------------------

struct IKArgs {
  // inputs: the carried blends, the assembled CVAE-stream pose (float32),
  // the contact flags of the frame (S, 2) and the carried contact state
  // (flags (S, 2) bool, vectors (S, 2, 3) R)
  View ik_prev_pos, trans_prev_pos, trans_pos, trans_vel, trans_rot,
      contact_last;
  View state, lock, position, velocity, point, target, offset_position,
      offset_velocity;
  // outputs: (S, J, 3|4) float32, the new contact state
  void *ik_pos, *trans_blended, *ik_rot;
  void *new_state, *new_lock, *new_position, *new_velocity, *new_point,
      *new_target, *new_offset_position, *new_offset_velocity;
  double dt, max_length_buffer, foot_height, unlock_radius, damping, eydt,
      dt_eps;
  int chain[2][kMaxChain];  // root .. toe of each contact bone
  int chain_len[2];
  int S, J, ik;
};

// 0.5 * (prev + vel * dt) + 0.5 * pos
__device__ __forceinline__ N<float> blend(N<float> prev, N<float> vel,
                                          N<float> pos, double dt) {
  return 0.5 * (prev + vel * dt) + 0.5 * pos;
}

__device__ __forceinline__ V3<float> blend3(const IKArgs& a, int s, int j) {
  N<float> c[3];
  for (int k = 0; k < 3; ++k)
    c[k] = blend(ld<float>(a.ik_prev_pos, s, j, k),
                 ld<float>(a.trans_vel, s, j, k),
                 ld<float>(a.trans_pos, s, j, k), a.dt);
  return {c[0], c[1], c[2]};
}

template <class R>
__global__ void __launch_bounds__(kWarps * 32) pose_ik(const IKArgs a) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= a.S) return;
  const int J = a.J;
  const long long row0 = (long long)s * J;
  for (int e = lane; e < J * 3; e += 32) {
    const int j = e / 3, k = e % 3;
    const N<float> vel = ld<float>(a.trans_vel, s, j, k);
    const N<float> pos = ld<float>(a.trans_pos, s, j, k);
    static_cast<float*>(a.ik_pos)[row0 * 3 + e] =
        blend(ld<float>(a.ik_prev_pos, s, j, k), vel, pos, a.dt).v;
    static_cast<float*>(a.trans_blended)[row0 * 3 + e] =
        blend(ld<float>(a.trans_prev_pos, s, j, k), vel, pos, a.dt).v;
  }
  if (!a.ik) return;
  const int n0 = a.chain_len[0], n1 = a.chain_len[1];
  const int hip0 = a.chain[0][n0 - 4], knee0 = a.chain[0][n0 - 3];
  const int hip1 = a.chain[1][n1 - 4], knee1 = a.chain[1][n1 - 3];
  for (int e = lane; e < J * 4; e += 32) {
    const int j = e / 4;
    if (j != hip0 && j != knee0 && j != hip1 && j != knee1)
      static_cast<float*>(a.ik_rot)[row0 * 4 + e] =
          ld<float>(a.trans_rot, s, j, e % 4).v;
  }
  if (lane >= 2) return;
  const int leg = lane, n = a.chain_len[leg];

  // quat.fk of the blended pose down the leg's chain
  Q4<float> gr, gr_root, gr_hip, gr_knee;
  V3<float> gp, gp_hip, gp_knee, gp_heel;
  for (int i = 0; i < n; ++i) {
    const int j = a.chain[leg][i];
    const Q4<float> lrot = ld4<float>(a.trans_rot, s, j);
    const V3<float> lpos = blend3(a, s, j);
    if (i == 0) {
      gr = lrot;
      gp = lpos;
    } else {
      gp = mul_vec(gr, lpos) + gp;
      gr = mul(gr, lrot);
    }
    if (i == n - 5) gr_root = gr;
    if (i == n - 4) { gr_hip = gr; gp_hip = gp; }
    if (i == n - 3) { gr_knee = gr; gp_knee = gp; }
    if (i == n - 2) gp_heel = gp;
  }
  const V3<float> gp_toe = gp;

  // contact_update for the leg's toe, in R
  const bool state = flag(a.state, s, leg);
  const bool lock = flag(a.lock, s, leg);
  const bool input_state = ld<float>(a.contact_last, s, 0, leg) > 0.5;
  const V3<R> point = ld3<R>(a.point, s, leg);
  const V3<R> off_p0 = ld3<R>(a.offset_position, s, leg);
  const V3<R> off_v0 = ld3<R>(a.offset_velocity, s, leg);
  const V3<R> zero = {num<R>(0.0), num<R>(0.0), num<R>(0.0)};
  const V3<R> ip = to<R>(gp_toe);
  const V3<R> iv = (ip - ld3<R>(a.target, s, leg)) / a.dt_eps;
  const V3<R> in_x = where(lock, point, ip);
  const V3<R> in_v = where(lock, zero, iv);
  // update_pos: decay_spring_damper_pos, then the offsets added
  const V3<R> j1 = off_v0 + off_p0 * a.damping;
  const V3<R> off_p = a.eydt * (off_p0 + j1 * a.dt);
  const V3<R> off_v = a.eydt * (off_v0 - j1 * a.damping * a.dt);
  const V3<R> position = in_x + off_p;
  const V3<R> velocity = in_v + off_v;
  const bool unlock = lock && length(point - ip) > a.unlock_radius;
  const bool just_locked = !state && input_state;
  const V3<R> lock_point = {position.x, num<R>(a.foot_height), position.z};
  const V3<R> t1_off_p = (ip + off_p) - lock_point;
  const V3<R> t1_off_v = (iv + off_v) - zero;
  const bool just_unlocked =
      !just_locked && ((lock && state && !input_state) || unlock);
  const V3<R> t2_off_p = (point + off_p) - ip;
  const V3<R> t2_off_v = (zero + off_v) - iv;
  const long long c = (long long)s * 2 + leg;
  static_cast<uint8_t*>(a.new_state)[c] = input_state;
  static_cast<uint8_t*>(a.new_lock)[c] =
      just_locked ? 1 : just_unlocked ? 0 : lock;
  st3(a.new_position, c, position);
  st3(a.new_velocity, c, velocity);
  st3(a.new_point, c, where(just_locked, lock_point, point));
  st3(a.new_target, c, ip);
  st3(a.new_offset_position, c,
      where(just_locked, t1_off_p, where(just_unlocked, t2_off_p, off_p)));
  st3(a.new_offset_velocity, c,
      where(just_locked, t1_off_v, where(just_unlocked, t2_off_v, off_v)));

  // _ik_fixup's target and pole, then quat.ik_two_bone
  const V3<R> clamped = {position.x, clamp_min(position.y, a.foot_height),
                         position.z};
  const V3<R> target = clamped + (gp_heel - gp_toe);
  const V3<float> up = {num<float>(0.0), num<float>(1.0), num<float>(0.0)};
  const V3<float> fwd = mul_vec(gr_knee, up);
  const V3<float> root = gp_hip, mid = gp_knee, end = gp_heel;

  const N<float> max_extension =
      length(root - mid) + length(mid - end) - a.max_length_buffer;
  const V3<R> to_target = target - root;
  const bool too_far = length(to_target) > max_extension;
  const V3<R> t =
      where(too_far, root + max_extension * normalize(to_target), target);

  const V3<float> axis_dwn = normalize(end - root);
  const V3<float> axis_rot = normalize(cross(axis_dwn, fwd));
  const N<float> lab = length(mid - root);
  const N<float> lcb = length(mid - end);
  const N<R> lat = length(t - root);
  const N<float> ac_ab_0 = arccos(clamp(
      dot(normalize(end - root), normalize(mid - root)), -1.0, 1.0));
  const N<float> ba_bc_0 = arccos(clamp(
      dot(normalize(root - mid), normalize(end - mid)), -1.0, 1.0));
  const N<R> ac_ab_1 = arccos(clamp(
      (lab * lab + lat * lat - lcb * lcb) / (2.0 * lab * lat), -1.0, 1.0));
  const N<R> ba_bc_1 = arccos(clamp(
      (lab * lab + lcb * lcb - lat * lat) / (2.0 * lab * lcb), -1.0, 1.0));
  const Q4<R> r0 = from_angle_axis(ac_ab_1 - ac_ab_0, axis_rot);
  const Q4<R> r1 = from_angle_axis(ba_bc_1 - ba_bc_0, axis_rot);
  const V3<float> c_a = normalize(end - root);
  const V3<R> t_a = normalize(t - root);
  const Q4<R> r2 = from_angle_axis(arccos(clamp(dot(c_a, t_a), -1.0, 1.0)),
                                   normalize(cross(c_a, t_a)));
  const Q4<R> hip_lr = inv_mul(gr_root, mul(r2, mul(r0, gr_hip)));
  const Q4<R> knee_lr = inv_mul(gr_hip, mul(r1, gr_knee));
  const int hip = leg == 0 ? hip0 : hip1, knee = leg == 0 ? knee0 : knee1;
  st4(a.ik_rot, row0 + hip, to<float>(hip_lr));
  st4(a.ik_rot, row0 + knee, to<float>(knee_lr));
}

View take_view(const long long*& c) {
  View v{reinterpret_cast<const void*>(c[0]), c[1], c[2], c[3]};
  c += 4;
  return v;
}

void* take_out(const long long*& c) {
  return reinterpret_cast<void*>(*c++);
}

int blocks(int S) { return (S + kWarps - 1) / kWarps; }

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success); S = 0 launches nothing.  `views` holds each input as four
// ints (address, stream, joint and element strides in elements) and each
// output as its address, in the order they are taken below; `scalars` the
// Python floats.  root_f64 picks R: 1 float64, 0 float32.
extern "C" int mocha_pose_roots(int root_f64, const long long* views,
                                const double* scalars, int S, int J,
                                void* stream) {
  if (S < 0 || J < 1 || views == nullptr || scalars == nullptr)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const long long* c = views;
  RootsArgs a;
  a.src_pos0 = take_view(c);
  a.src_rot0 = take_view(c);
  a.trans_pos0 = take_view(c);
  a.trans_rot0 = take_view(c);
  a.cm_pos0 = take_view(c);
  a.cm_rot0 = take_view(c);
  a.rvel = take_view(c);
  a.rang = take_view(c);
  a.pos_last = take_view(c);
  a.rot_last = take_view(c);
  a.vel_last = take_view(c);
  a.ang_last = take_view(c);
  a.hips_speed = take_view(c);
  a.t_pos = take_view(c);
  a.t_rot = take_view(c);
  a.t_vel = take_view(c);
  a.t_speed = take_view(c);
  a.c_pos = take_view(c);
  a.c_rot = take_view(c);
  a.c_speed = take_view(c);
  a.src_pos = take_out(c);
  a.src_rot = take_out(c);
  a.src_vel = take_out(c);
  a.src_ang = take_out(c);
  a.trans_pos = take_out(c);
  a.trans_rot = take_out(c);
  a.trans_vel = take_out(c);
  a.cm_pos = take_out(c);
  a.cm_rot = take_out(c);
  a.new_src_pos0 = take_out(c);
  a.new_src_rot0 = take_out(c);
  a.new_trans_pos0 = take_out(c);
  a.new_trans_rot0 = take_out(c);
  a.new_cm_pos0 = take_out(c);
  a.new_cm_rot0 = take_out(c);
  a.dt = scalars[0];
  a.S = S;
  a.J = J;
  cudaStream_t s = (cudaStream_t)stream;
  if (root_f64)
    pose_roots<double><<<blocks(S), kWarps * 32, 0, s>>>(a);
  else
    pose_roots<float><<<blocks(S), kWarps * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// `chains` holds the two chains' lengths, then each chain's joints from
// the root to the toe (parents before children, at least 5 and at most
// kMaxChain joints each).  ik = 0 only blends.
extern "C" int mocha_pose_ik(int root_f64, const long long* views,
                             const double* scalars, const int* chains, int S,
                             int J, int ik, void* stream) {
  if (S < 0 || J < 1 || views == nullptr || scalars == nullptr ||
      chains == nullptr)
    return (int)cudaErrorInvalidValue;
  IKArgs a;
  const int* joints = chains + 2;
  for (int leg = 0; leg < 2; ++leg) {
    const int n = chains[leg];
    if (ik && (n < 5 || n > kMaxChain)) return (int)cudaErrorInvalidValue;
    a.chain_len[leg] = n;
    for (int i = 0; i < kMaxChain; ++i) {
      a.chain[leg][i] = i < n ? joints[i] : 0;
      if (i < n && (joints[i] < 0 || joints[i] >= J))
        return (int)cudaErrorInvalidValue;
    }
    joints += n;
  }
  if (S == 0) return 0;
  const long long* c = views;
  a.ik_prev_pos = take_view(c);
  a.trans_prev_pos = take_view(c);
  a.trans_pos = take_view(c);
  a.trans_vel = take_view(c);
  a.trans_rot = take_view(c);
  a.contact_last = take_view(c);
  a.state = take_view(c);
  a.lock = take_view(c);
  a.position = take_view(c);
  a.velocity = take_view(c);
  a.point = take_view(c);
  a.target = take_view(c);
  a.offset_position = take_view(c);
  a.offset_velocity = take_view(c);
  a.ik_pos = take_out(c);
  a.trans_blended = take_out(c);
  a.ik_rot = take_out(c);
  a.new_state = take_out(c);
  a.new_lock = take_out(c);
  a.new_position = take_out(c);
  a.new_velocity = take_out(c);
  a.new_point = take_out(c);
  a.new_target = take_out(c);
  a.new_offset_position = take_out(c);
  a.new_offset_velocity = take_out(c);
  a.dt = scalars[0];
  a.max_length_buffer = scalars[1];
  a.foot_height = scalars[2];
  a.unlock_radius = scalars[3];
  a.damping = scalars[4];
  a.eydt = scalars[5];
  a.dt_eps = scalars[6];
  a.S = S;
  a.J = J;
  a.ik = ik;
  cudaStream_t s = (cudaStream_t)stream;
  if (root_f64)
    pose_ik<double><<<blocks(S), kWarps * 32, 0, s>>>(a);
  else
    pose_ik<float><<<blocks(S), kWarps * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}
