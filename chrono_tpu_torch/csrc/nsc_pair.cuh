// Per-contact NSC/DVI math for the APGD sweeps: the contact frame of a sphere
// pair or of a sphere and a wall, the normal-row right-hand side, the
// friction-cone projection and the constraint-space velocity.
//
// The same math as chrono_tpu_torch/ops/nsc_pair.py (the sweeps' plain
// twins) and as the elementwise helpers of
// chrono_tpu/ops/pallas/nsc_pencil_kernel.py (pair_geometry:60,
// contact_rhs:94, cone_project:101, pair_velocity:115, wall_geometry:135),
// term by term.  Two details must stay as they are there: the tangent basis
// picks its helper axis branch-free from |n_x| < 0.9, so that it maps exactly
// under a side swap (t1(-n) = -t1(n), t2(-n) = t2(n)); and the rotbox normal
// uses sign(0) = 0, not copysignf, so a body at a face centre gets no normal
// component along that face.
#pragma once

#include <cuda_runtime.h>

constexpr int kMaxWalls = 8;
enum { kPlane = 0, kCyl = 1, kRotbox = 2 };

struct NscWall {
  int kind, axis, rb;  // rb: the rotbox's row of the pose array cs
  float a[3];          // plane normal | centre
  float off;           // plane offset | cylinder radius
  float v[3];          // plane surface velocity | rotbox half extents
  float spin, mu;
};

struct NscParams {
  float radius, inv_m, inv_I, envelope, mu, omega, stab_over_h, inv_h,
      max_recovery, inv_Ib;
  int n_walls;
  NscWall walls[kMaxWalls];
};

// Normal (self -> other), tangents, signed gap and lever arm of a contact.
struct Frame {
  float n[3], t1[3], t2[3];
  float gap, arm;
};

__device__ __forceinline__ void frame_tangents(Frame& f, float radius) {
  const float nx = f.n[0], ny = f.n[1], nz = f.n[2];
  const float use_x = fabsf(nx) < 0.9f ? 1.0f : 0.0f;
  float t1x = (1.0f - use_x) * (-nz);
  float t1y = use_x * nz;
  float t1z = use_x * (-ny) + (1.0f - use_x) * nx;
  const float tn = rsqrtf(t1x * t1x + t1y * t1y + t1z * t1z + 1e-18f);
  t1x *= tn;
  t1y *= tn;
  t1z *= tn;
  f.t1[0] = t1x;
  f.t1[1] = t1y;
  f.t1[2] = t1z;
  f.t2[0] = ny * t1z - nz * t1y;
  f.t2[1] = nz * t1x - nx * t1z;
  f.t2[2] = nx * t1y - ny * t1x;
  f.arm = radius + 0.5f * fminf(f.gap, 0.0f);
}

// Sphere pair: self at s, other at b.
__device__ __forceinline__ Frame pair_frame(const float s[3], const float b[3],
                                            float radius) {
  Frame f;
  const float d[3] = {b[0] - s[0], b[1] - s[1], b[2] - s[2]};
  const float d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const float inv = rsqrtf(d2 + 1e-18f);
  f.gap = d2 * inv - 2.0f * radius;
  for (int a = 0; a < 3; ++a) f.n[a] = d[a] * inv;
  frame_tangents(f, radius);
  return f;
}

__device__ __forceinline__ float sign0(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Sphere at p against wall w: the frame (normal self -> wall) and the wall's
// surface velocity vs at the contact.  cs holds (cos t, sin t, spin) per
// rotbox; a rotbox takes its spin from there, not from w.spin.
__device__ __forceinline__ Frame wall_frame(const NscWall& w, const float p[3],
                                            float radius, const float* cs,
                                            float vs[3]) {
  Frame f;
  if (w.kind == kPlane) {
    f.gap = w.a[0] * p[0] + w.a[1] * p[1] + w.a[2] * p[2] - w.off - radius;
    for (int a = 0; a < 3; ++a) {
      f.n[a] = -w.a[a];
      vs[a] = w.v[a];
    }
  } else if (w.kind == kCyl) {
    float r[3] = {p[0] - w.a[0], p[1] - w.a[1], p[2] - w.a[2]};
    r[w.axis] = 0.0f;
    const float d2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
    const float inv = rsqrtf(d2 + 1e-18f);
    for (int a = 0; a < 3; ++a) f.n[a] = r[a] * inv;   // radial, outward
    f.gap = (w.off - d2 * inv) - radius;
    // spin * axis x (R n)
    const float sr = w.spin * w.off;
    const int a1 = (w.axis + 1) % 3, a2 = (w.axis + 2) % 3;
    vs[w.axis] = 0.0f;
    vs[a1] = sr * (-f.n[a2]);
    vs[a2] = sr * f.n[a1];
  } else {
    const float cth = cs[3 * w.rb], sth = cs[3 * w.rb + 1];
    const float spin = cs[3 * w.rb + 2];
    // local frame: the rotation axis is the third component
    const int i3 = w.axis, i1 = (w.axis + 1) % 3, i2 = (w.axis + 2) % 3;
    const float a1 = p[i1] - w.a[i1], a2 = p[i2] - w.a[i2];
    const float a3 = p[i3] - w.a[i3];
    const float u = cth * a1 + sth * a2;
    const float v = -sth * a1 + cth * a2;
    const float qu = fabsf(u) - w.v[0], qv = fabsf(v) - w.v[1];
    const float qw = fabsf(a3) - w.v[2];
    const float ou = fmaxf(qu, 0.0f), ov = fmaxf(qv, 0.0f);
    const float ow = fmaxf(qw, 0.0f);
    const float d_out = sqrtf(ou * ou + ov * ov + ow * ow + 1e-18f);
    const float q_in = fminf(fmaxf(fmaxf(qu, qv), qw), 0.0f);
    const float sdf = q_in < 0.0f ? q_in : d_out;
    const float is_out = q_in >= 0.0f ? 1.0f : 0.0f;
    const float inv_do = 1.0f / d_out;
    const float iu = (qu >= qv && qu >= qw) ? 1.0f : 0.0f;
    const float iv = (qv > qu && qv >= qw) ? 1.0f : 0.0f;
    const float iw = 1.0f - iu - iv;
    const float su = sign0(u), sv = sign0(v), sw = sign0(a3);
    const float inner = 1.0f - is_out;
    const float nl_u = is_out * (su * ou * inv_do) + inner * (su * iu);
    const float nl_v = is_out * (sv * ov * inv_do) + inner * (sv * iv);
    const float nl_w = is_out * (sw * ow * inv_do) + inner * (sw * iw);
    // outward normal in the world frame; the contact normal is its opposite
    f.n[i1] = -(cth * nl_u - sth * nl_v);
    f.n[i2] = -(sth * nl_u + cth * nl_v);
    f.n[i3] = -nl_w;
    f.gap = sdf - radius;
    // spin * axis x (p - c)
    vs[i1] = -spin * a2;
    vs[i2] = spin * a1;
    vs[i3] = 0.0f;
  }
  frame_tangents(f, radius);
  return f;
}

// Normal-row b_n: the clamped penetration recovery where gap < 0, the free
// approach up to the gap where gap > 0.
__device__ __forceinline__ float contact_rhs(float gap, const NscParams& k) {
  return gap < 0.0f ? fminf(-k.stab_over_h * gap, k.max_recovery)
                    : -k.inv_h * gap;
}

// Projection onto the friction cone of coefficient mu, in place.
__device__ __forceinline__ void cone_project(float& gn, float& gu, float& gv,
                                             float mu) {
  const float tnorm = sqrtf(gu * gu + gv * gv + 1e-18f);
  const float inside = tnorm <= mu * gn ? 1.0f : 0.0f;
  const float polar = mu * tnorm <= -gn ? 1.0f : 0.0f;
  const float gn_s = fmaxf((tnorm * mu + gn) / (mu * mu + 1.0f), 0.0f);
  const float scale_t = mu * gn_s / tnorm;
  const float ts = inside + (1.0f - inside) * (1.0f - polar) * scale_t;
  gn = inside * gn + (1.0f - inside) * (1.0f - polar) * gn_s;
  gu *= ts;
  gv *= ts;
}

// (n.v_r, t1.v_r, t2.v_r) with v_r = v_other - v_self - arm (w_self +
// w_other) x n.
__device__ __forceinline__ void pair_velocity(const Frame& f, const float sv[3],
                                              const float nv[3],
                                              const float sw[3],
                                              const float nw[3], float g[3]) {
  const float ws[3] = {sw[0] + nw[0], sw[1] + nw[1], sw[2] + nw[2]};
  const float c[3] = {ws[1] * f.n[2] - ws[2] * f.n[1],
                      ws[2] * f.n[0] - ws[0] * f.n[2],
                      ws[0] * f.n[1] - ws[1] * f.n[0]};
  float vr[3];
  for (int a = 0; a < 3; ++a) vr[a] = nv[a] - sv[a] - f.arm * c[a];
  g[0] = vr[0] * f.n[0] + vr[1] * f.n[1] + vr[2] * f.n[2];
  g[1] = vr[0] * f.t1[0] + vr[1] * f.t1[1] + vr[2] * f.t1[2];
  g[2] = vr[0] * f.t2[0] + vr[1] * f.t2[1] + vr[2] * f.t2[2];
}

// The impulse y = (yn, yu, yv) along the frame's rows: F = yn n + yu t1 +
// yv t2 and the torque arm (yv t1 - yu t2).  On self the force is -F.
__device__ __forceinline__ void row_impulse(const Frame& f, const float y[3],
                                            float F[3], float T[3]) {
  for (int a = 0; a < 3; ++a) {
    F[a] = y[0] * f.n[a] + y[1] * f.t1[a] + y[2] * f.t2[a];
    T[a] = f.arm * (y[2] * f.t1[a] - y[1] * f.t2[a]);
  }
}
