// Per-scenario rigid-body dynamics and goal cost of the soft arm: the device
// library that the linearization (linearize.cu) and rollout (rollout.cu)
// kernels inline. It replaces aslr_to_tpu/ops/lanes.py as traced inside
// the Pallas kernels of aslr_to_tpu/pallas/vsa_kernels.py
// (_dynamics_lanes, _goal_cost_lanes, _running_cost_lanes).
//
// Every function is templated on the value type V: float or double for
// values, Dual<float> or Dual<double> (common.cuh) where the linearization
// needs forward-mode partials. Operations follow the JAX code's order one
// for one; the plain PyTorch twin is aslr_to_tpu_torch/ops/lanes.py.
// Constants come from the parameter block in float64 and are rounded to the
// scalar type at their use, as JAX rounds a baked Python float.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace aslr {

template <class V> struct Vec3 { V x[3]; };
template <class V> struct Mat3 { V m[3][3]; };

template <class V> __device__ inline typename scalar_of<V>::type cst(double c) {
  return (typename scalar_of<V>::type)c;
}

// The vector and matrix operations take a scalar and a dual operand alike
// (Mix: a scalar times a dual is a dual). The robot's constants stay
// scalars, as the plain version's constant tensors do, so a constant times a
// dual performs the plain version's two multiplications, not the three
// multiplications and an add of a dual with a zero tangent (whose 0 * inf
// would also turn an infinite value into a NaN tangent).
template <class A, class B> struct Mix { typedef A type; };
template <class S> struct Mix<S, Dual<S>> { typedef Dual<S> type; };
template <class A, class B> using mix_t = typename Mix<A, B>::type;

template <class A, class B>
__device__ inline Vec3<mix_t<A, B>> v_add(const Vec3<A>& a, const Vec3<B>& b) {
  return {{a.x[0] + b.x[0], a.x[1] + b.x[1], a.x[2] + b.x[2]}};
}
template <class A, class B>
__device__ inline Vec3<mix_t<A, B>> v_sub(const Vec3<A>& a, const Vec3<B>& b) {
  return {{a.x[0] - b.x[0], a.x[1] - b.x[1], a.x[2] - b.x[2]}};
}
template <class A, class B>
__device__ inline mix_t<A, B> v_dot(const Vec3<A>& a, const Vec3<B>& b) {
  return a.x[0] * b.x[0] + a.x[1] * b.x[1] + a.x[2] * b.x[2];
}
template <class A, class B>
__device__ inline Vec3<mix_t<A, B>> v_cross(const Vec3<A>& a, const Vec3<B>& b) {
  return {{a.x[1] * b.x[2] - a.x[2] * b.x[1],
           a.x[2] * b.x[0] - a.x[0] * b.x[2],
           a.x[0] * b.x[1] - a.x[1] * b.x[0]}};
}
// a constant vector or matrix of the parameter block, as scalars of V's type
template <class V> __device__ inline Vec3<typename scalar_of<V>::type> v_const(const double* c) {
  return {{cst<V>(c[0]), cst<V>(c[1]), cst<V>(c[2])}};
}
template <class V> __device__ inline Mat3<typename scalar_of<V>::type> m_const(const double (*c)[3]) {
  Mat3<typename scalar_of<V>::type> M;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) M.m[i][j] = cst<V>(c[i][j]);
  return M;
}
// a scalar vector as a V vector (a dual with a zero tangent)
template <class V, class S> __device__ inline Vec3<V> v_lift(const Vec3<S>& a) {
  return {{V(a.x[0]), V(a.x[1]), V(a.x[2])}};
}
template <class V> __device__ inline Vec3<V> v_zero() { return {{V(cst<V>(0.0)), V(cst<V>(0.0)), V(cst<V>(0.0))}}; }
// A @ v
template <class A, class B>
__device__ inline Vec3<mix_t<A, B>> m_vec(const Mat3<A>& M, const Vec3<B>& v) {
  Vec3<mix_t<A, B>> r;
  for (int i = 0; i < 3; ++i) r.x[i] = M.m[i][0] * v.x[0] + M.m[i][1] * v.x[1] + M.m[i][2] * v.x[2];
  return r;
}
// A^T @ v
template <class A, class B>
__device__ inline Vec3<mix_t<A, B>> m_t_vec(const Mat3<A>& M, const Vec3<B>& v) {
  Vec3<mix_t<A, B>> r;
  for (int j = 0; j < 3; ++j) r.x[j] = M.m[0][j] * v.x[0] + M.m[1][j] * v.x[1] + M.m[2][j] * v.x[2];
  return r;
}
template <class A, class B>
__device__ inline Mat3<mix_t<A, B>> m_mul(const Mat3<A>& X, const Mat3<B>& Y) {
  Mat3<mix_t<A, B>> C;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C.m[i][j] = X.m[i][0] * Y.m[0][j] + X.m[i][1] * Y.m[1][j] + X.m[i][2] * Y.m[2][j];
  return C;
}

// Rodrigues rotation about a constant unit axis by angle q
template <class V> __device__ inline Mat3<V> rot_axis_angle(const double* axis, V q) {
  const double ax = axis[0], ay = axis[1], az = axis[2];
  V c = dcos(q), s = dsin(q);
  V C = cst<V>(1.0) - c;
  Mat3<V> R;
  R.m[0][0] = c + cst<V>(ax * ax) * C;
  R.m[0][1] = cst<V>(ax * ay) * C - cst<V>(az) * s;
  R.m[0][2] = cst<V>(ax * az) * C + cst<V>(ay) * s;
  R.m[1][0] = cst<V>(ay * ax) * C + cst<V>(az) * s;
  R.m[1][1] = c + cst<V>(ay * ay) * C;
  R.m[1][2] = cst<V>(ay * az) * C - cst<V>(ax) * s;
  R.m[2][0] = cst<V>(az * ax) * C - cst<V>(ay) * s;
  R.m[2][1] = cst<V>(az * ay) * C + cst<V>(ax) * s;
  R.m[2][2] = c + cst<V>(az * az) * C;
  return R;
}

// world placement of the goal frame at link angles q. The chain is serial
// (parent of joint i is i - 1, checked by the parameter packer), so every
// index below is a compile-time constant once the loops unroll. With GIVEN,
// the joints' rotations (joint_rotation of q) come from Eg(i).
template <class V, int NL, bool GIVEN = false, class ROT = const Mat3<V>*>
__device__ inline void frame_placement(const VSAParams<NL>& P, const V* q, Mat3<V>& R, Vec3<V>& p,
                                       ROT Eg = nullptr) {
  Mat3<V> rot, rot_f;
  Vec3<V> trans, trans_f;
  for (int i = 0; i < NL; ++i) {
    Mat3<V> E;
    if constexpr (GIVEN) E = Eg(i);
    else E = m_mul(m_const<V>(P.joint_rot[i]), rot_axis_angle(P.axis[i], q[i]));
    const auto pi = v_const<V>(P.joint_pos[i]);
    if (i == 0) {
      rot = E;
      trans = v_lift<V>(pi);
    } else {
      trans = v_add(m_vec(rot, pi), trans);
      rot = m_mul(rot, E);
    }
    if (i == P.frame_parent) {
      rot_f = rot;
      trans_f = trans;
    }
  }
  R = m_mul(rot_f, m_const<V>(P.frame_rot));
  p = v_add(m_vec(rot_f, v_const<V>(P.frame_pos)), trans_f);
}

// one joint's constants, and its frame's rotation in its parent's at angle
// q: rot R(axis, q), as rnea computes it
struct Joint {
  double rot[3][3], axis[3];
};
template <class V>
__device__ inline Mat3<V> joint_rotation(const Joint& j, V q) {
  return m_mul(m_const<V>(j.rot), rot_axis_angle(j.axis, q));
}
// joint i's constants, i a value (a select over the chain, no indexed load)
template <int NL>
__device__ inline Joint joint_of(const VSAParams<NL>& P, int i) {
  Joint j;
  for (int k = 0; k < NL; ++k)
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) j.rot[a][b] = k == 0 || k == i ? P.joint_rot[k][a][b] : j.rot[a][b];
      j.axis[a] = k == 0 || k == i ? P.axis[k][a] : j.axis[a];
    }
  return j;
}

// inverse dynamics of the serial chain (ops/lanes.py::rnea_lanes); with
// GIVEN, the joints' rotations (joint_rotation of q) come in Eg: an array,
// or a source whose Eg(i) gives joint i's
template <class V, int NL, bool GIVEN = false, class ROT = const Mat3<V>*>
__device__ inline void rnea(const VSAParams<NL>& P, const V* q, const V* v, const V* a,
                            bool gravity, V* tau, ROT Eg = nullptr) {
  Mat3<V> Es[NL];
  Vec3<V> vs[NL], ws[NL], als[NL], aas[NL], f_lin[NL], f_ang[NL];
  const Vec3<V> zero = v_zero<V>();
  for (int i = 0; i < NL; ++i) {
    Mat3<V> E;
    if constexpr (GIVEN && std::is_pointer_v<ROT>) E = Eg[i];
    else if constexpr (GIVEN) E = Eg(i);
    else E = m_mul(m_const<V>(P.joint_rot[i]), rot_axis_angle(P.axis[i], q[i]));
    const auto p = v_const<V>(P.joint_pos[i]);
    Es[i] = E;
    Vec3<V> vp, wp, ap, alp;
    if (i == 0) {
      vp = zero;
      wp = zero;
      if (gravity) {
        double mg[3] = {-P.gravity[0], -P.gravity[1], -P.gravity[2]};
        ap = v_lift<V>(v_const<V>(mg));
      } else {
        ap = zero;
      }
      alp = zero;
    } else {
      vp = vs[i - 1];
      wp = ws[i - 1];
      ap = als[i - 1];
      alp = aas[i - 1];
    }
    Vec3<V> vi = m_t_vec(E, v_add(vp, v_cross(wp, p)));
    Vec3<V> wi = m_t_vec(E, wp);
    Vec3<V> ai = m_t_vec(E, v_add(ap, v_cross(alp, p)));
    Vec3<V> ali = m_t_vec(E, alp);
    const auto axis = v_const<V>(P.axis[i]);
    Vec3<V> wJ = {{v[i] * axis.x[0], v[i] * axis.x[1], v[i] * axis.x[2]}};
    Vec3<V> aJ = {{a[i] * axis.x[0], a[i] * axis.x[1], a[i] * axis.x[2]}};
    Vec3<V> w_tot = v_add(wi, wJ);
    vs[i] = vi;
    ws[i] = w_tot;
    als[i] = v_add(ai, v_cross(vi, wJ));
    aas[i] = v_add(v_add(ali, aJ), v_cross(w_tot, wJ));

    const auto m_i = cst<V>(P.mass[i]);
    const auto c = v_const<V>(P.com[i]);
    const auto Ic = m_const<V>(P.inertia[i]);
    // momentum of body i: h_lin = m (v + w x c), h_ang = I w + c x h_lin
    Vec3<V> t1 = v_add(vs[i], v_cross(ws[i], c));
    Vec3<V> h_lin = {{m_i * t1.x[0], m_i * t1.x[1], m_i * t1.x[2]}};
    Vec3<V> h_ang = v_add(m_vec(Ic, ws[i]), v_cross(c, h_lin));
    Vec3<V> t2 = v_add(als[i], v_cross(aas[i], c));
    Vec3<V> ha_lin = {{m_i * t2.x[0], m_i * t2.x[1], m_i * t2.x[2]}};
    Vec3<V> ha_ang = v_add(m_vec(Ic, aas[i]), v_cross(c, ha_lin));
    f_lin[i] = v_add(ha_lin, v_cross(ws[i], h_lin));
    f_ang[i] = v_add(ha_ang, v_add(v_cross(ws[i], h_ang), v_cross(vs[i], h_lin)));
  }
  for (int i = NL - 1; i >= 0; --i) {
    tau[i] = v_dot(v_const<V>(P.axis[i]), f_ang[i]);
    if (i > 0) {
      if constexpr (GIVEN && !std::is_pointer_v<ROT>) {
        // a source gives joint i's rotation again, which then need not stay
        // live across the sweep
        const Mat3<V> E = Eg(i);
        Vec3<V> fp = m_vec(E, f_lin[i]);
        Vec3<V> tp = v_add(m_vec(E, f_ang[i]), v_cross(v_const<V>(P.joint_pos[i]), fp));
        f_lin[i - 1] = v_add(f_lin[i - 1], fp);
        f_ang[i - 1] = v_add(f_ang[i - 1], tp);
      } else {
        Vec3<V> fp = m_vec(Es[i], f_lin[i]);
        Vec3<V> tp = v_add(m_vec(Es[i], f_ang[i]), v_cross(v_const<V>(P.joint_pos[i]), fp));
        f_lin[i - 1] = v_add(f_lin[i - 1], fp);
        f_ang[i - 1] = v_add(f_ang[i - 1], tp);
      }
    }
  }
}

// rnea with the joints' rotations from a source Eg(i) (read twice, in each
// pass), whose forward pass carries the parent's velocities and
// accelerations in registers instead of arrays indexed by the joint: where
// the pass stays a loop (nl = 7), those arrays sat in local memory on the
// knot's chain. The same operations in the same order as rnea's, so the
// same bits; only the forces wait for the backward pass in arrays.
template <class V, int NL, class ROT>
__device__ inline void rnea_carry(const VSAParams<NL>& P, const V* v, const V* a, bool gravity,
                                  V* tau, ROT Eg) {
  Vec3<V> f_lin[NL], f_ang[NL];
  const Vec3<V> zero = v_zero<V>();
  Vec3<V> vp = zero, wp = zero, ap, alp = zero;
  if (gravity) {
    double mg[3] = {-P.gravity[0], -P.gravity[1], -P.gravity[2]};
    ap = v_lift<V>(v_const<V>(mg));
  } else {
    ap = zero;
  }
  for (int i = 0; i < NL; ++i) {
    const Mat3<V> E = Eg(i);
    const auto p = v_const<V>(P.joint_pos[i]);
    Vec3<V> vi = m_t_vec(E, v_add(vp, v_cross(wp, p)));
    Vec3<V> wi = m_t_vec(E, wp);
    Vec3<V> ai = m_t_vec(E, v_add(ap, v_cross(alp, p)));
    Vec3<V> ali = m_t_vec(E, alp);
    const auto axis = v_const<V>(P.axis[i]);
    Vec3<V> wJ = {{v[i] * axis.x[0], v[i] * axis.x[1], v[i] * axis.x[2]}};
    Vec3<V> aJ = {{a[i] * axis.x[0], a[i] * axis.x[1], a[i] * axis.x[2]}};
    Vec3<V> w_tot = v_add(wi, wJ);
    const Vec3<V> al_i = v_add(ai, v_cross(vi, wJ));
    const Vec3<V> aa_i = v_add(v_add(ali, aJ), v_cross(w_tot, wJ));

    const auto m_i = cst<V>(P.mass[i]);
    const auto c = v_const<V>(P.com[i]);
    const auto Ic = m_const<V>(P.inertia[i]);
    Vec3<V> t1 = v_add(vi, v_cross(w_tot, c));
    Vec3<V> h_lin = {{m_i * t1.x[0], m_i * t1.x[1], m_i * t1.x[2]}};
    Vec3<V> h_ang = v_add(m_vec(Ic, w_tot), v_cross(c, h_lin));
    Vec3<V> t2 = v_add(al_i, v_cross(aa_i, c));
    Vec3<V> ha_lin = {{m_i * t2.x[0], m_i * t2.x[1], m_i * t2.x[2]}};
    Vec3<V> ha_ang = v_add(m_vec(Ic, aa_i), v_cross(c, ha_lin));
    f_lin[i] = v_add(ha_lin, v_cross(w_tot, h_lin));
    f_ang[i] = v_add(ha_ang, v_add(v_cross(w_tot, h_ang), v_cross(vi, h_lin)));
    vp = vi;
    wp = w_tot;
    ap = al_i;
    alp = aa_i;
  }
  for (int i = NL - 1; i >= 0; --i) {
    tau[i] = v_dot(v_const<V>(P.axis[i]), f_ang[i]);
    if (i > 0) {
      const Mat3<V> E = Eg(i);
      Vec3<V> fp = m_vec(E, f_lin[i]);
      Vec3<V> tp = v_add(m_vec(E, f_ang[i]), v_cross(v_const<V>(P.joint_pos[i]), fp));
      f_lin[i - 1] = v_add(f_lin[i - 1], fp);
      f_ang[i - 1] = v_add(f_ang[i - 1], tp);
    }
  }
}

// sweep c of mass_nle: c = 0 the nle (velocity v, no acceleration, with
// gravity), c > 0 column c - 1 of M (no velocity, unit acceleration of
// link c - 1, no gravity). c may differ from thread to thread: the inputs
// are chosen by value, so every sweep runs the same instructions.
// With GIVEN, the joints' rotations come in Eg (as rnea's).
// With CARRY (a source Eg), rnea_carry.
template <class V, int NL, bool GIVEN = false, class ROT = const Mat3<V>*, bool CARRY = false>
__device__ inline void mass_nle_sweep(const VSAParams<NL>& P, const V* q, const V* v, int c,
                                      V* out, ROT Eg = nullptr) {
  V vc[NL], ac[NL];
  for (int i = 0; i < NL; ++i) {
    vc[i] = c == 0 ? v[i] : V(cst<V>(0.0));
    ac[i] = V(cst<V>(c == i + 1 ? 1.0 : 0.0));
  }
  if constexpr (CARRY) rnea_carry<V, NL, ROT>(P, vc, ac, c == 0, out, Eg);
  else rnea<V, NL, GIVEN, ROT>(P, q, vc, ac, c == 0, out, Eg);
}

// mass matrix M (from unit-acceleration RNEA columns) and nle
template <class V, int NL>
__device__ inline void mass_nle(const VSAParams<NL>& P, const V* q, const V* v, V (*M)[NL], V* nle) {
  V col[NL];
  mass_nle_sweep<V, NL>(P, q, v, 0, nle);
  for (int j = 0; j < NL; ++j) {
    mass_nle_sweep<V, NL>(P, q, v, j + 1, col);
    for (int i = 0; i < NL; ++i) M[i][j] = col[i];
  }
}

// unrolled n x n Cholesky (lower factor, rows) and its solve
template <class V, int N>
__device__ inline void choln(V (*A)[N], V (*L)[N]) {
  for (int i = 0; i < N; ++i)
    for (int j = 0; j <= i; ++j) {
      V s = A[i][j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? dsqrt(s) : s / L[j][j];
    }
}

template <class V, int N>
__device__ inline void choln_solve(V (*L)[N], const V* b, V* x) {
  V y[N];
  for (int i = 0; i < N; ++i) {
    V s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = N - 1; i >= 0; --i) {
    V s = y[i];
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// SPD solve M x = b: the 2x2 closed form at NL = 2, else Cholesky
template <class V, int NL>
__device__ inline void solven(V (*M)[NL], const V* b, V* x) {
  if constexpr (NL == 2) {
    V det = M[0][0] * M[1][1] - M[0][1] * M[1][0];
    V inv_det = cst<V>(1.0) / det;
    x[0] = (M[1][1] * b[0] - M[0][1] * b[1]) * inv_det;
    x[1] = (M[0][0] * b[1] - M[1][0] * b[0]) * inv_det;
  } else {
    V L[NL][NL];
    choln<V, NL>(M, L);
    choln_solve<V, NL>(L, b, x);
  }
}

// axis-angle of a rotation (ops/lanes.py::log3_lanes): sanitized branches so
// the tangents of the branches not taken stay finite (theta = 0 and pi)
template <class V>
__device__ inline Vec3<V> log3(const Mat3<V>& R) {
  V trace = R.m[0][0] + R.m[1][1] + R.m[2][2];
  V cc = dclip((trace - cst<V>(1.0)) * cst<V>(0.5), V(cst<V>(-1.0)), V(cst<V>(1.0)));
  V u = cst<V>(1.0) - cc;
  V s = cst<V>(1.0) + cc;
  Vec3<V> vee = {{(R.m[2][1] - R.m[1][2]) * cst<V>(0.5),
                  (R.m[0][2] - R.m[2][0]) * cst<V>(0.5),
                  (R.m[1][0] - R.m[0][1]) * cst<V>(0.5)}};
  const bool small = val(u) < cst<V>(5e-7);
  const bool near_pi = val(s) < cst<V>(5e-5);
  const bool generic = !(small || near_pi);

  V vv = v_dot(vee, vee);
  V sin_theta = dsqrt(sel(generic, vv, V(cst<V>(1.0))));
  V theta = datan2(sel(generic, sin_theta, V(cst<V>(0.0))), sel(generic, cc, V(cst<V>(1.0))));
  V fac_gen = theta / sin_theta;

  V theta2_t = cst<V>(2.0) * u * (cst<V>(1.0) + u / cst<V>(6.0));
  V fac_small = cst<V>(1.0) + theta2_t / cst<V>(6.0);

  V theta_pi = cst<V>(M_PI) - dsqrt(dmax(cst<V>(2.0) * s, V(cst<V>(1e-30)))) *
                                   (cst<V>(1.0) + s / cst<V>(12.0));
  V diag[3] = {R.m[0][0], R.m[1][1], R.m[2][2]};
  V umax = dmax(u, V(cst<V>(1e-30)));
  V fac = sel(small, fac_small, fac_gen);
  Vec3<V> w;
  for (int i = 0; i < 3; ++i) {
    V ratio = (diag[i] - cc) / umax;
    const bool pos = val(ratio) > cst<V>(1e-6);
    V ax = sel(pos, dsqrt(sel(pos, ratio, V(cst<V>(1.0)))), V(cst<V>(0.0)));
    const auto sg = cst<V>(val(vee.x[i]) < cst<V>(0.0) ? -1.0 : 1.0);
    V w_pi = ax * sg * theta_pi;
    V w_gen = fac * vee.x[i];
    w.x[i] = sel(near_pi, w_pi, w_gen);
  }
  return w;
}

// SE(3) log [v; w] (ops/lanes.py::log6_lanes)
template <class V>
__device__ inline void log6(const Mat3<V>& R, const Vec3<V>& p, V* r6) {
  Vec3<V> w = log3(R);
  V theta2 = v_dot(w, w);
  const bool small = val(theta2) < cst<V>(1e-12);
  V safe_t2 = sel(small, V(cst<V>(1.0)), theta2);
  V theta = dsqrt(safe_t2);
  V sin_t = dsin(theta);
  V denom = cst<V>(2.0) * theta * sin_t;
  V safe_denom = sel(val(dabs(denom)) < cst<V>(1e-12), V(cst<V>(1.0)), denom);
  V k = sel(small, cst<V>(1.0 / 12.0) + theta2 / cst<V>(720.0),
            cst<V>(1.0) / safe_t2 - (cst<V>(1.0) + dcos(theta)) / safe_denom);
  Vec3<V> wxp = v_cross(w, p);
  Vec3<V> wxwxp = v_cross(w, wxp);
  for (int i = 0; i < 3; ++i) r6[i] = p.x[i] - cst<V>(0.5) * wxp.x[i] + k * wxwxp.x[i];
  for (int i = 0; i < 3; ++i) r6[3 + i] = w.x[i];
}

// goal residual r6 = log6(target^-1 * oMf) and its cost 0.5 |r6|^2
// (vsa_kernels.py::_goal_cost_lanes) against the target ``row`` of a
// [T, 12] table (R_inv row by row, then the position;
// vsa_kernels.py::VSASpec.target_table), or where it is null the
// parameter block's running or terminal target; with GIVEN, the joints'
// rotations from Eg(i) (frame_placement's)
template <class V, int NL, bool GIVEN = false, class ROT = const Mat3<V>*>
__device__ inline V goal_cost(const VSAParams<NL>& P, const V* q_l, bool terminal,
                              const typename scalar_of<V>::type* row, V* r6, ROT Eg = nullptr) {
  Mat3<V> R;
  Vec3<V> p;
  frame_placement<V, NL, GIVEN, ROT>(P, q_l, R, p, Eg);
  // the target, entry by entry
  Mat3<typename scalar_of<V>::type> Ri;
  Vec3<typename scalar_of<V>::type> tp;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Ri.m[i][j] = row ? row[3 * i + j]
                       : cst<V>(terminal ? P.term_rinv[i][j] : P.tgt_rinv[i][j]);
    tp.x[i] = row ? row[9 + i] : cst<V>(terminal ? P.term_pos[i] : P.tgt_pos[i]);
  }
  Mat3<V> rM = m_mul(Ri, R);
  Vec3<V> rp = m_vec(Ri, v_sub(p, tp));
  log6(rM, rp, r6);
  V c = r6[0] * r6[0];
  for (int i = 1; i < 6; ++i) c = c + r6[i] * r6[i];
  return cst<V>(0.5) * c;
}

// the spring torque tau_c = k (q_l - q_m) with the VSA's stiffness
// controls, or K (q_l - q_m) with the SEA's constant spring matrix
template <class S, int NL, bool SEA>
__device__ inline void spring_torque(const VSAParams<NL>& P, const S* x, const S* u, S* tau_c) {
  const S* q_l = x;
  const S* q_m = x + NL;
  if constexpr (SEA) {
    S d[NL];
    for (int i = 0; i < NL; ++i) d[i] = q_l[i] - q_m[i];
    for (int i = 0; i < NL; ++i) {
      S acc = S(P.K[i][0]) * d[0];
      for (int j = 1; j < NL; ++j) acc = acc + S(P.K[i][j]) * d[j];
      tau_c[i] = acc;
    }
  } else {
    for (int i = 0; i < NL; ++i) tau_c[i] = u[NL + i] * (q_l[i] - q_m[i]);
  }
}

// the link accelerations from M and nle, and the motor accelerations
// Binv (u + tau_c)
template <class S, int NL>
__device__ inline void accelerations(const VSAParams<NL>& P, const S* u, const S* tau_c,
                                     S (*M)[NL], const S* nle, S* a) {
  S rhs[NL];
  for (int i = 0; i < NL; ++i) rhs[i] = -nle[i] - tau_c[i];
  solven<S, NL>(M, rhs, a);
  for (int i = 0; i < NL; ++i) {
    S acc = S(P.binv[i][0]) * (u[0] + tau_c[0]);
    for (int j = 1; j < NL; ++j) acc = acc + S(P.binv[i][j]) * (u[j] + tau_c[j]);
    a[NL + i] = acc;
  }
}

// soft-arm accelerations a [2 NL] (vsa_kernels.py::_dynamics_lanes); also
// hands back M and tau_c for the linearization
template <class S, int NL, bool SEA>
__device__ inline void arm_dynamics(const VSAParams<NL>& P, const S* x, const S* u, S* a,
                                    S (*M)[NL], S* tau_c) {
  spring_torque<S, NL, SEA>(P, x, u, tau_c);
  S nle[NL];
  mass_nle<S, NL>(P, x, x + 2 * NL, M, nle);
  accelerations<S, NL>(P, u, tau_c, M, nle, a);
}

// running cost: w_goal * goal + state/control regularization + stiffness
// (vsa_kernels.py::_running_cost_lanes); the stiffness cost only where the
// controls carry stiffnesses (the VSA, not the SEA); the goal's target: a
// table's ``row``, or where it is null the parameter block's; with GIVEN,
// the joints' rotations from Eg(i) (goal_cost's)
template <class S, int NL, bool SEA, bool GIVEN = false, class ROT = const Mat3<S>*>
__device__ inline S running_cost(const VSAParams<NL>& P, const S* x, const S* u,
                                 const S* row = nullptr, ROT Eg = nullptr) {
  constexpr int NU = Arm<NL, SEA>::NU;
  S r6[6];
  S c = S(P.w_goal) * goal_cost<S, NL, GIVEN, ROT>(P, x, false, row, r6, Eg);
  for (int i = 0; i < 4 * NL; ++i)
    if (P.xw[i] != 0.0) c = c + S(0.5 * P.xw[i]) * x[i] * x[i];
  for (int i = 0; i < NU; ++i)
    if (P.uw[i] != 0.0) c = c + S(0.5 * P.uw[i]) * u[i] * u[i];
  if constexpr (!SEA) {
    if (P.stiff_w != 0.0)
      for (int i = 0; i < NL; ++i) c = c + S(P.stiff_w) * (u[NL + i] - S(P.stiff_ref[i]));
  }
  return c;
}

// semi-implicit Euler: q' = q + v dt + a dt^2, v' = v + a dt
template <class S, int NL>
__device__ inline void euler(double dt, const S* x, const S* a, S* x_new) {
  constexpr int nv = 2 * NL;
  for (int i = 0; i < nv; ++i) x_new[i] = x[i] + x[nv + i] * S(dt) + a[i] * S(dt) * S(dt);
  for (int i = 0; i < nv; ++i) x_new[nv + i] = x[nv + i] + a[i] * S(dt);
}

}  // namespace aslr
