// Element layer of the Newton solve of thinshelllab_torch: every element
// family's energy, gradient and Hessian block (element_eval), and the fused
// padded block group the assembly reads (element_fuse), for sm_90a (H100).
//
// Replaces no TPU kernel: the JAX package evaluates the elements with XLA's
// vmap(jacfwd(grad)) over ops/energies.py. The port's eager torch.func chain
// of the same (engine/elements.all_groups on the CPU) issued about 5,500
// device operations a Newton iteration on the folding task, 84% of the
// forward step's, each on a batch of 90 to 1,365 elements: the card idled
// 97% of the time while the host launched them. Here the whole evaluation is
// two launches, with the batched eigh projection (ops/spd) between them.
//
// What bounds it: latency, not bytes or operations. On folding in f64
// element_eval reads the scene and writes its blocks, 2.9 MB, and
// element_fuse reads the blocks and writes the fused group (H is
// (3069, 4, 4, 3, 3), 3.5 MB), 6.5 MB: about 1 and 2 us at 3.35 TB/s. A
// thread does 10^3-10^4 operations, a few 10^8 in all, microseconds at the
// card's f64 rate. So the design is for launch count: one launch over all
// families, blocks assigned to families by index ranges (block_end), a
// grid-stride loop inside each family's range with 64-bit offsets (the 40k
// drape's 80k hinges take 6.2M threads' worth of items).
//
// element_eval. A thread owns one (element, Hessian entry i <= j) of its
// family and evaluates the element's energy once on a hyper-dual scalar
// HD<T> (value, e1, e2, e1e2 parts), seeding coordinate i along e1 and j
// along e2: the e1e2 part is d2E/dx_i dx_j exactly to rounding, the e1
// part dE/dx_i. Each energy is one template <class T, class S> function
// in the arithmetic of ops/energies.py (S = T or HD<T>): membrane (edge and
// area terms), bending (hinge_angle's atan2, the stencil rows picked by the
// hinge's one-hot selection rows, exact like its 0/1 multiply-reduce), the
// neo-Hookean (clamp(J, 0.01) log) and tactile tets in D-space, the
// barrier in R-space (its g < eps switch). Diagonal threads also write the
// gradient and the energy. Friction is closed form, one thread a contact
// slot: g1 = k f1(r) T^T u, h1 = k T^T h T, h = f1 I + (f1'/r) u u^T with
// the reference's r > 1e-9 cut, projected to PSD in 2x2 when spd.
// Output blocks, in the layouts engine/elements hands to project_psd:
//   Hm (nf, 9, 9) rows (a, i) = 3a + i, gm (nf, 3, 3), em (nf)
//   Hb (nh, 12, 12), gb (nh, 4, 3), eb (nh): masked hinges read zero
//   Hn / Ht (T, 9, 9) over D[i][j] = x_j[i] - x_3[i] (row 3i + j), and
//   Gn / Gt (T, 3, 3), en / et (T)
//   Hr (C, 9, 9) over R[r][i] = x_{r+1}[i] - x_0[i], Gr (C, 3, 3), ec (C)
//   g1f (C, 3), h1f (C, 3, 3), ef (C): friction, unmasked
//
// element_fuse. A thread owns one entry (e, a, b, i, k) of the fused H
// (E, 4, 4, 3, 3); those with b = k = 0 write g (E, 4, 3), those with
// b = i = k = 0 idx (E, 4). Rows in engine/elements.fuse_groups' order
// (membrane, bending, neo, tact, contact), 3-vertex faces padded with the
// ghost vertex nv; the tets' S-map and the contact's relative map as
// _tet_g/_tet_H and _rel_g/_rel_H write them, the contact rows masked by
// `active` with friction added.
//
// Built two ways from this one file: nvcc for the card (the kernels and
// tsl_element_*_f32/f64), and g++ (-x c++) for the host, where the same
// per-item functions run in plain loops (tsl_element_*_host_*). The CPU
// tests build and load it (tests/_element_host.py) and hold it against the
// torch.func route, so the arithmetic and the layouts are tested without a
// card.
//
// Every card entry point launches on the given stream and returns a CUDA
// error code (0 on success).

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TSL_HD __host__ __device__ __forceinline__
#else
#define TSL_HD inline
#endif

// The entry points' arguments, outside the anonymous namespace so that the
// extern "C" functions keep external linkage. Every field is 8 bytes, so
// the ctypes mirror in ops/element_kernels.py (EVAL_FIELDS, FUSE_FIELDS)
// has no padding to match.
struct EvalArgs {
  int64_t nv, nf, nh, nn, nt, nc, spd;
  double k_contact, eps_contact, eh;
  const void* pos;
  const int64_t* f2v;
  const int64_t* cloth_id;
  const void* l0;
  const void* rest_area;
  const void* kl;
  const void* ka;
  const int64_t* hinge_verts;
  const void* hinge_sel;
  const uint8_t* hinge_mask;
  const void* canon;
  const void* ref_angle;
  const void* hinge_coef;
  const int64_t* hinge_cloth;
  const void* kb;
  const int64_t* neo_tets;
  const void* neo_B;
  const void* neo_W;
  const int64_t* neo_group;
  const void* neo_mu;
  const void* neo_lam;
  const int64_t* tact_tets;
  const void* tact_B;
  const void* tact_W;
  const int64_t* tact_group;
  const void* tact_mu;
  const void* tact_lam;
  const int64_t* cidx;
  const void* cw;
  const void* cdx0;
  const void* ct;
  const void* ck;
  void* Hm; void* gm; void* em;
  void* Hb; void* gb; void* eb;
  void* Hn; void* Gn; void* en;
  void* Ht; void* Gt; void* et;
  void* Hr; void* Gr; void* ec;
  void* g1f; void* h1f; void* ef;
  int64_t block_end[6];  // kFamilies
};

struct FuseArgs {
  int64_t nv, nf, nh, nn, nt, nc;
  const int64_t* f2v;
  const int64_t* hinge_verts;
  const int64_t* neo_tets;
  const int64_t* tact_tets;
  const int64_t* cidx;
  const uint8_t* active;
  const void* cw;
  const void* Hm; const void* gm;
  const void* Hb; const void* gb;
  const void* Hn; const void* Gn;
  const void* Ht; const void* Gt;
  const void* Hr; const void* Gr;
  const void* g1f; const void* h1f;
  int64_t* idx_out;
  void* g_out;
  void* H_out;
  int64_t blocks;
};

namespace {

constexpr int kFamilies = 6;  // membrane, bending, neo, tact, barrier, friction
constexpr int kThreads = 128;
constexpr int64_t kMaxBlocks = 4096;  // per family; grid-stride beyond

// --------------------------------------------------------------------------
// Hyper-dual scalar: x = v + a e1 + b e2 + ab e1e2, e1^2 = e2^2 = 0.
// --------------------------------------------------------------------------

template <class T>
struct HD {
  T v, a, b, ab;
  TSL_HD HD() {}
  TSL_HD HD(T c) : v(c), a(0), b(0), ab(0) {}
  TSL_HD HD(T v_, T a_, T b_, T ab_) : v(v_), a(a_), b(b_), ab(ab_) {}

  friend TSL_HD HD operator+(const HD& x, const HD& y) {
    return HD(x.v + y.v, x.a + y.a, x.b + y.b, x.ab + y.ab);
  }
  friend TSL_HD HD operator-(const HD& x, const HD& y) {
    return HD(x.v - y.v, x.a - y.a, x.b - y.b, x.ab - y.ab);
  }
  friend TSL_HD HD operator-(const HD& x, T c) { return HD(x.v - c, x.a, x.b, x.ab); }
  friend TSL_HD HD operator-(T c, const HD& x) { return HD(c - x.v, -x.a, -x.b, -x.ab); }
  friend TSL_HD HD operator*(const HD& x, const HD& y) {
    return HD(x.v * y.v, x.v * y.a + x.a * y.v, x.v * y.b + x.b * y.v,
              x.v * y.ab + x.a * y.b + x.b * y.a + x.ab * y.v);
  }
  friend TSL_HD HD operator*(const HD& x, T c) { return HD(x.v * c, x.a * c, x.b * c, x.ab * c); }
  friend TSL_HD HD operator*(T c, const HD& x) { return HD(c * x.v, c * x.a, c * x.b, c * x.ab); }
  // q = x / y from x = q y, part by part
  friend TSL_HD HD operator/(const HD& x, const HD& y) {
    T q = x.v / y.v;
    T qa = (x.a - q * y.a) / y.v;
    T qb = (x.b - q * y.b) / y.v;
    return HD(q, qa, qb, (x.ab - qa * y.b - qb * y.a - q * y.ab) / y.v);
  }
  friend TSL_HD HD operator/(const HD& x, T c) { return HD(x.v / c, x.a / c, x.b / c, x.ab / c); }
};

// f(x) from f, f' and f'' at x.v
template <class T>
TSL_HD HD<T> chain(const HD<T>& x, T f, T f1, T f2) {
  return HD<T>(f, f1 * x.a, f1 * x.b, f1 * x.ab + f2 * x.a * x.b);
}

TSL_HD double val(double x) { return x; }
TSL_HD float val(float x) { return x; }
template <class T>
TSL_HD T val(const HD<T>& x) { return x.v; }

TSL_HD double sqrt_(double x) { return sqrt(x); }
TSL_HD float sqrt_(float x) { return sqrtf(x); }
template <class T>
TSL_HD HD<T> sqrt_(const HD<T>& x) {
  T f = sqrt_(x.v);
  return chain(x, f, T(0.5) / f, T(-0.25) / (f * x.v));
}

TSL_HD double log_(double x) { return log(x); }
TSL_HD float log_(float x) { return logf(x); }
template <class T>
TSL_HD HD<T> log_(const HD<T>& x) {
  T r = T(1) / x.v;
  return chain(x, log_(x.v), r, -r * r);
}

TSL_HD double atan2_(double y, double x) { return atan2(y, x); }
TSL_HD float atan2_(float y, float x) { return atan2f(y, x); }
template <class T>
TSL_HD HD<T> atan2_(const HD<T>& y, const HD<T>& x) {
  T r2 = x.v * x.v + y.v * y.v;
  T fx = -y.v / r2, fy = x.v / r2;
  T r4 = r2 * r2;
  T fxx = T(2) * x.v * y.v / r4, fxy = (y.v * y.v - x.v * x.v) / r4;
  return HD<T>(atan2_(y.v, x.v), fx * x.a + fy * y.a, fx * x.b + fy * y.b,
               fx * x.ab + fy * y.ab + fxx * (x.a * x.b - y.a * y.b) +
                   fxy * (x.a * y.b + y.a * x.b));
}

template <class S>
TSL_HD void sub3(const S* a, const S* b, S* c) {
  c[0] = a[0] - b[0];
  c[1] = a[1] - b[1];
  c[2] = a[2] - b[2];
}

template <class S>
TSL_HD void cross3(const S* a, const S* b, S* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

template <class S>
TSL_HD S dot3(const S* a, const S* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <class S>
TSL_HD void normalize3(S* a) {
  S n = sqrt_(dot3(a, a));
  a[0] = a[0] / n;
  a[1] = a[1] / n;
  a[2] = a[2] / n;
}

// --------------------------------------------------------------------------
// The energies of ops/energies.py, one element each.
// --------------------------------------------------------------------------

// x[3 l + i]: face vertex l; edge l runs x_l -> x_{(l+1) % 3}
template <class T, class S>
TSL_HD S membrane_energy(const S* x, const T* l0, T rest_area, T kl, T ka) {
  S e_sum = S(T(0));
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    S d[3];
    sub3(x + 3 * l, x + 3 * ((l + 1) % 3), d);
    S q = T(1) - sqrt_(dot3(d, d)) / l0[l];
    e_sum = e_sum + kl * (q * q) * l0[l];
  }
  S c1[3], c2[3], n[3];
  sub3(x + 3, x, c1);
  sub3(x + 6, x, c2);
  cross3(c1, c2, n);
  S area = sqrt_(dot3(n, n)) * T(0.5);
  S q = T(1) - area / rest_area;
  return e_sum + ka * (q * q) * rest_area;
}

// x[3 v + i]: stencil vertex v; sel (4, 4) one-hot rows picking xa, xb, ea, eb
template <class T, class S>
TSL_HD S bending_energy(const S* x, const T* sel, T ref, T coef, T kb) {
  S rows[4][3];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < 3; ++i) rows[r][i] = S(T(0));
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (sel[4 * r + k] != T(0)) {
#pragma unroll
        for (int i = 0; i < 3; ++i) rows[r][i] = x[3 * k + i];
      }
  }
  S u[3], v[3], n1[3], n2[3], e[3], c[3];
  sub3(x + 3, x, u);
  sub3(x + 6, x + 3, v);
  cross3(u, v, n1);
  normalize3(n1);
  sub3(rows[0], x + 9, u);
  sub3(rows[1], rows[0], v);
  cross3(u, v, n2);
  normalize3(n2);
  sub3(rows[3], rows[2], e);
  normalize3(e);
  cross3(n1, n2, c);
  S d = atan2_(dot3(c, e), dot3(n1, n2)) - ref;
  return kb * (d * d) * coef;
}

// F = D B, row-major 3x3
template <class T, class S>
TSL_HD void deformation(const S* D, const T* B, S* F) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      F[3 * i + k] = D[3 * i] * B[k] + D[3 * i + 1] * B[3 + k] +
                     D[3 * i + 2] * B[6 + k];
}

template <class S>
TSL_HD S det3(const S* F) {
  return F[0] * (F[4] * F[8] - F[5] * F[7]) - F[1] * (F[3] * F[8] - F[5] * F[6]) +
         F[2] * (F[3] * F[7] - F[4] * F[6]);
}

template <class S>
TSL_HD S frob2(const S* F) {
  S s = F[0] * F[0];
#pragma unroll
  for (int q = 1; q < 9; ++q) s = s + F[q] * F[q];
  return s;
}

template <class T, class S>
TSL_HD S neo_energy(const S* D, const T* B, T W, T mu, T lam) {
  S F[9];
  deformation(D, B, F);
  S J = det3(F);
  // clamp(J, min=0.01): J where J >= 0.01 (the derivative passes there)
  S logJ = log_(val(J) >= T(0.01) ? J : S(T(0.01)));
  S phi = T(0.5) * mu * (frob2(F) - T(3)) - mu * logJ + T(0.5) * lam * (logJ * logJ);
  return W * phi;
}

template <class T, class S>
TSL_HD S tactile_energy(const S* D, const T* B, T W, T mu, T lam) {
  S F[9];
  deformation(D, B, F);
  S d = det3(F) - (T(1) + mu / lam);
  S phi = T(0.5) * mu * (frob2(F) - T(3)) + T(0.5) * lam * (d * d);
  return W * phi;
}

// R[3 r + i]: rows a = p1 - p0, b = p2 - p0, c = p - p0
template <class T, class S>
TSL_HD S barrier_energy(const S* R, T half_k, T eps) {
  S ab[3];
  cross3(R, R + 3, ab);
  S g = dot3(ab, R + 6) / sqrt_(dot3(ab, ab));
  if (!(val(g) < eps)) return S(T(0));
  S d = g - eps;
  return (d * d) * half_k;
}

// --------------------------------------------------------------------------
// element_eval items
// --------------------------------------------------------------------------

template <class T> struct Limits;
template <> struct Limits<double> { static TSL_HD double tiny() { return 2.2250738585072014e-308; } };
template <> struct Limits<float> { static TSL_HD float tiny() { return 1.17549435e-38f; } };

// entry q of the upper triangle of an N x N matrix, row by row -> (i, j)
template <int N>
TSL_HD void upper_pair(int q, int& i, int& j) {
  i = 0;
  while (q >= N - i) {
    q -= N - i;
    ++i;
  }
  j = i + q;
}

template <int N, class T>
TSL_HD void seed(const T* x, int i, int j, HD<T>* xs) {
#pragma unroll
  for (int q = 0; q < N; ++q) xs[q] = HD<T>(x[q], T(q == i), T(q == j), T(0));
}

// H[e] entry (i, j) and (j, i); the diagonal threads write g[e, i] and,
// for i = 0, the energy. m: the element's 0/1 mask.
template <int N, class T>
TSL_HD void store(const HD<T>& E, int64_t e, int i, int j, T m, void* H,
                  void* g, void* en) {
  T* He = static_cast<T*>(H) + e * (N * N);
  T h = E.ab * m;
  He[i * N + j] = h;
  He[j * N + i] = h;
  if (i == j) {
    static_cast<T*>(g)[e * N + i] = E.a * m;
    if (i == 0) static_cast<T*>(en)[e] = E.v * m;
  }
}

template <class T>
TSL_HD void membrane_item(const EvalArgs& a, int64_t t) {
  const T* pos = static_cast<const T*>(a.pos);
  int64_t e = t / 45;
  int i, j;
  upper_pair<9>(static_cast<int>(t - e * 45), i, j);
  T x[9];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    int64_t p = a.f2v[3 * e + v];
#pragma unroll
    for (int c = 0; c < 3; ++c) x[3 * v + c] = pos[3 * p + c];
  }
  int64_t cid = a.cloth_id[e];
  HD<T> xs[9];
  seed<9>(x, i, j, xs);
  HD<T> E = membrane_energy<T>(xs, static_cast<const T*>(a.l0) + 3 * e,
                               static_cast<const T*>(a.rest_area)[e],
                               static_cast<const T*>(a.kl)[cid],
                               static_cast<const T*>(a.ka)[cid]);
  store<9>(E, e, i, j, T(1), a.Hm, a.gm, a.em);
}

template <class T>
TSL_HD void bending_item(const EvalArgs& a, int64_t t) {
  const T* pos = static_cast<const T*>(a.pos);
  const T* canon = static_cast<const T*>(a.canon);
  int64_t e = t / 78;
  int i, j;
  upper_pair<12>(static_cast<int>(t - e * 78), i, j);
  bool on = a.hinge_mask[e] != 0;
  T x[12];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    int64_t p = a.hinge_verts[4 * e + v];
#pragma unroll
    for (int c = 0; c < 3; ++c) x[3 * v + c] = on ? pos[3 * p + c] : canon[3 * v + c];
  }
  HD<T> xs[12];
  seed<12>(x, i, j, xs);
  HD<T> E = bending_energy<T>(xs, static_cast<const T*>(a.hinge_sel) + 16 * e,
                              static_cast<const T*>(a.ref_angle)[e],
                              static_cast<const T*>(a.hinge_coef)[e],
                              static_cast<const T*>(a.kb)[a.hinge_cloth[e]]);
  store<12>(E, e, i, j, on ? T(1) : T(0), a.Hb, a.gb, a.eb);
}

template <class T, bool kNeo>
TSL_HD void tet_item(const EvalArgs& a, int64_t t) {
  const T* pos = static_cast<const T*>(a.pos);
  const int64_t* tets = kNeo ? a.neo_tets : a.tact_tets;
  int64_t e = t / 45;
  int i, j;
  upper_pair<9>(static_cast<int>(t - e * 45), i, j);
  int64_t p3 = tets[4 * e + 3];
  T D[9];
#pragma unroll
  for (int col = 0; col < 3; ++col) {
    int64_t p = tets[4 * e + col];
#pragma unroll
    for (int r = 0; r < 3; ++r) D[3 * r + col] = pos[3 * p + r] - pos[3 * p3 + r];
  }
  const T* B = static_cast<const T*>(kNeo ? a.neo_B : a.tact_B) + 9 * e;
  T W = static_cast<const T*>(kNeo ? a.neo_W : a.tact_W)[e];
  int64_t gid = (kNeo ? a.neo_group : a.tact_group)[e];
  T mu = static_cast<const T*>(kNeo ? a.neo_mu : a.tact_mu)[gid];
  T lam = static_cast<const T*>(kNeo ? a.neo_lam : a.tact_lam)[gid];
  HD<T> Ds[9];
  seed<9>(D, i, j, Ds);
  HD<T> E = kNeo ? neo_energy<T>(Ds, B, W, mu, lam) : tactile_energy<T>(Ds, B, W, mu, lam);
  if (kNeo)
    store<9>(E, e, i, j, T(1), a.Hn, a.Gn, a.en);
  else
    store<9>(E, e, i, j, T(1), a.Ht, a.Gt, a.et);
}

template <class T>
TSL_HD void barrier_item(const EvalArgs& a, int64_t t) {
  const T* pos = static_cast<const T*>(a.pos);
  int64_t e = t / 45;
  int i, j;
  upper_pair<9>(static_cast<int>(t - e * 45), i, j);
  int64_t p0 = a.cidx[4 * e];
  T R[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    int64_t p = a.cidx[4 * e + r + 1];
#pragma unroll
    for (int c = 0; c < 3; ++c) R[3 * r + c] = pos[3 * p + c] - pos[3 * p0 + c];
  }
  HD<T> Rs[9];
  seed<9>(R, i, j, Rs);
  HD<T> E = barrier_energy<T>(Rs, T(0.5 * a.k_contact), T(a.eps_contact));
  store<9>(E, e, i, j, T(1), a.Hr, a.Gr, a.ec);
}

template <class T>
TSL_HD T fmax_(T x, T lo) { return x < lo ? lo : x; }

// closed-form 2x2 PSD projection (ops/spd.project_psd_2x2), in place
template <class T>
TSL_HD void project_psd_2x2(T* h) {
  T a = h[0], b = T(0.5) * (h[1] + h[2]), c = h[3];
  T tr = a + c;
  T hd = (a - c) * T(0.5);
  T det_s = sqrt_(fmax_(hd * hd + b * b, T(0)));
  T l1 = T(0.5) * tr + det_s, l2 = T(0.5) * tr - det_s;
  bool nondeg = (b < T(0) ? -b : b) > Limits<T>::tiny();
  T vx = nondeg ? b : T(1), vy = nondeg ? l1 - a : T(0);
  T nrm = sqrt_(vx * vx + vy * vy);
  vx = vx / nrm;
  vy = vy / nrm;
  T l1c = fmax_(l1, T(0)), l2c = fmax_(l2, T(0));
  T off = (l1c - l2c) * vx * vy;
  h[0] = l1c * vx * vx + l2c * vy * vy;
  h[1] = off;
  h[2] = off;
  h[3] = l1c * vy * vy + l2c * vx * vx;
}

// one thread a contact slot (engine/elements.friction_eval)
template <class T>
TSL_HD void friction_item(const EvalArgs& a, int64_t c) {
  const T* pos = static_cast<const T*>(a.pos);
  const T* w = static_cast<const T*>(a.cw) + 3 * c;
  const T* dx0 = static_cast<const T*>(a.cdx0) + 3 * c;
  const T* Tf = static_cast<const T*>(a.ct) + 6 * c;
  T k = static_cast<const T*>(a.ck)[c];
  const T tiny = Limits<T>::tiny();
  T dx[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T xcen = w[0] * pos[3 * a.cidx[4 * c] + i] + w[1] * pos[3 * a.cidx[4 * c + 1] + i] +
             w[2] * pos[3 * a.cidx[4 * c + 2] + i];
    dx[i] = pos[3 * a.cidx[4 * c + 3] + i] - xcen - dx0[i];
  }
  T u[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) u[s] = Tf[3 * s] * dx[0] + Tf[3 * s + 1] * dx[1] + Tf[3 * s + 2] * dx[2];
  T r = sqrt_(u[0] * u[0] + u[1] * u[1] + tiny);
  T eh = T(a.eh);
  bool far = r > eh;
  T f1 = far ? T(1) / fmax_(r, tiny) : -r / T(a.eh * a.eh) + T(2.0 / a.eh);
  T f0 = far ? r : -(r * r * r) / T(3.0 * a.eh * a.eh) + r * r / eh + T(a.eh / 3.0);
  static_cast<T*>(a.ef)[c] = k * f0;
  T gu[2] = {u[0] * (k * f1), u[1] * (k * f1)};
  T* g1 = static_cast<T*>(a.g1f) + 3 * c;
#pragma unroll
  for (int i = 0; i < 3; ++i) g1[i] = gu[0] * Tf[i] + gu[1] * Tf[3 + i];
  T rc = fmax_(r, tiny);
  T f1p = far ? T(-1) / (rc * rc) : T(-1.0 / (a.eh * a.eh));
  // the reference drops the outer-product term for r <= 1e-9
  T coef = r > T(1e-9) ? f1p / fmax_(r, T(1e-9)) : T(0);
  T h[4] = {f1 + coef * u[0] * u[0], coef * u[0] * u[1], coef * u[1] * u[0],
            f1 + coef * u[1] * u[1]};
  if (a.spd) project_psd_2x2(h);
  T* h1 = static_cast<T*>(a.h1f) + 9 * c;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T s = T(0);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 2; ++q) s = s + Tf[3 * p + i] * h[2 * p + q] * Tf[3 * q + j];
      h1[3 * i + j] = k * s;
    }
}

TSL_HD int64_t family_items(const EvalArgs& a, int f) {
  switch (f) {
    case 0: return a.nf * 45;
    case 1: return a.nh * 78;
    case 2: return a.nn * 45;
    case 3: return a.nt * 45;
    case 4: return a.nc * 45;
    default: return a.nc;
  }
}

template <class T>
TSL_HD void eval_item(const EvalArgs& a, int f, int64_t t) {
  switch (f) {
    case 0: membrane_item<T>(a, t); break;
    case 1: bending_item<T>(a, t); break;
    case 2: tet_item<T, true>(a, t); break;
    case 3: tet_item<T, false>(a, t); break;
    case 4: barrier_item<T>(a, t); break;
    default: friction_item<T>(a, t); break;
  }
}

// --------------------------------------------------------------------------
// element_fuse items: entry t of the fused H (E, 4, 4, 3, 3)
// --------------------------------------------------------------------------

template <class T>
TSL_HD void fuse_item(const FuseArgs& a, int64_t t) {
  int64_t e = t / 144;
  int q = static_cast<int>(t - e * 144);
  int A = q / 36, B = (q / 9) % 4, i = (q / 3) % 3, k = q % 3;
  bool wg = B == 0 && k == 0, wi = wg && i == 0;
  T h = T(0), g = T(0);
  int64_t id = a.nv;
  int64_t r = e;
  if (r < a.nf) {
    if (A < 3 && B < 3) h = static_cast<const T*>(a.Hm)[81 * r + 9 * (3 * A + i) + 3 * B + k];
    if (A < 3) {
      if (wg) g = static_cast<const T*>(a.gm)[9 * r + 3 * A + i];
      if (wi) id = a.f2v[3 * r + A];
    }
  } else if ((r -= a.nf) < a.nh) {
    h = static_cast<const T*>(a.Hb)[144 * r + 12 * (3 * A + i) + 3 * B + k];
    if (wg) g = static_cast<const T*>(a.gb)[12 * r + 3 * A + i];
    if (wi) id = a.hinge_verts[4 * r + A];
  } else if ((r -= a.nh) < a.nn + a.nt) {
    // _tet_g / _tet_H: g[a] = G[:, a], H[a, b] = Hd[:, a, :, b] for a, b < 3;
    // the fourth row and column are minus the sums of the others
    bool neo = r < a.nn;
    if (!neo) r -= a.nn;
    const T* Hd = static_cast<const T*>(neo ? a.Hn : a.Ht) + 81 * r;
    const T* G = static_cast<const T*>(neo ? a.Gn : a.Gt) + 9 * r;
    const int64_t* tets = neo ? a.neo_tets : a.tact_tets;
    auto hd = [&](int j, int l) { return Hd[9 * (3 * i + j) + 3 * k + l]; };
    auto row3 = [&](int l) { return -(hd(0, l) + hd(1, l) + hd(2, l)); };
    if (A < 3 && B < 3) h = hd(A, B);
    else if (A < 3) h = -(hd(A, 0) + hd(A, 1) + hd(A, 2));
    else if (B < 3) h = row3(B);
    else h = -(row3(0) + row3(1) + row3(2));
    if (wg) g = A < 3 ? G[3 * i + A] : -(G[3 * i] + G[3 * i + 1] + G[3 * i + 2]);
    if (wi) id = tets[4 * r + A];
  } else {
    r -= a.nn + a.nt;
    // _rel_g / _rel_H (row 0 = minus the sums of the others) masked by
    // active, plus friction w1[A] w1[B] h1 and w1[A] g1, w1 = (-w, 1)
    const T* Hr = static_cast<const T*>(a.Hr) + 81 * r;
    const T* Gr = static_cast<const T*>(a.Gr) + 9 * r;
    const T* w = static_cast<const T*>(a.cw) + 3 * r;
    T m = a.active[r] ? T(1) : T(0);
    auto hr = [&](int s, int u) { return Hr[9 * (3 * s + i) + 3 * u + k]; };
    auto col0 = [&](int u) { return -(hr(0, u) + hr(1, u) + hr(2, u)); };
    T rel;
    if (A > 0 && B > 0) rel = hr(A - 1, B - 1);
    else if (B > 0) rel = col0(B - 1);
    else if (A > 0) rel = -(hr(A - 1, 0) + hr(A - 1, 1) + hr(A - 1, 2));
    else rel = -(col0(0) + col0(1) + col0(2));
    T wA = A < 3 ? -w[A] : T(1), wB = B < 3 ? -w[B] : T(1);
    h = rel * m + wA * wB * static_cast<const T*>(a.h1f)[9 * r + 3 * i + k] * m;
    if (wg) {
      T rg = A > 0 ? Gr[3 * (A - 1) + i] : -(Gr[i] + Gr[3 + i] + Gr[6 + i]);
      g = rg * m + wA * static_cast<const T*>(a.g1f)[3 * r + i] * m;
    }
    if (wi) id = a.cidx[4 * r + A];
  }
  static_cast<T*>(a.H_out)[t] = h;
  if (wg) static_cast<T*>(a.g_out)[12 * e + 3 * A + i] = g;
  if (wi) a.idx_out[4 * e + A] = id;
}

TSL_HD int64_t fuse_items(const FuseArgs& a) {
  return (a.nf + a.nh + a.nn + a.nt + a.nc) * 144;
}

#ifdef __CUDACC__

template <class T>
__global__ void __launch_bounds__(kThreads) element_eval_kernel(EvalArgs a) {
  int f = 0;
  while (f < kFamilies - 1 && blockIdx.x >= a.block_end[f]) ++f;
  int64_t b0 = f ? a.block_end[f - 1] : 0;
  int64_t stride = (a.block_end[f] - b0) * kThreads;
  int64_t n = family_items(a, f);
  for (int64_t t = (blockIdx.x - b0) * kThreads + threadIdx.x; t < n; t += stride)
    eval_item<T>(a, f, t);
}

template <class T>
__global__ void __launch_bounds__(kThreads) element_fuse_kernel(FuseArgs a) {
  int64_t n = fuse_items(a);
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; t < n;
       t += static_cast<int64_t>(gridDim.x) * kThreads)
    fuse_item<T>(a, t);
}

int64_t blocks_for(int64_t items) {
  int64_t b = (items + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

template <class T>
int launch_eval(EvalArgs* a, cudaStream_t stream) {
  int64_t end = 0;
  for (int f = 0; f < kFamilies; ++f) a->block_end[f] = end += blocks_for(family_items(*a, f));
  if (end == 0) return 0;
  element_eval_kernel<T><<<static_cast<unsigned>(end), kThreads, 0, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_fuse(FuseArgs* a, cudaStream_t stream) {
  a->blocks = blocks_for(fuse_items(*a));
  if (a->blocks == 0) return 0;
  element_fuse_kernel<T><<<static_cast<unsigned>(a->blocks), kThreads, 0, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

#else  // the host build of the CPU tests

template <class T>
int host_eval(EvalArgs* a) {
  for (int f = 0; f < kFamilies; ++f)
    for (int64_t t = 0, n = family_items(*a, f); t < n; ++t) eval_item<T>(*a, f, t);
  return 0;
}

template <class T>
int host_fuse(FuseArgs* a) {
  for (int64_t t = 0, n = fuse_items(*a); t < n; ++t) fuse_item<T>(*a, t);
  return 0;
}

#endif

}  // namespace

#ifdef __CUDACC__

extern "C" int tsl_element_eval_f32(EvalArgs* a, void* stream) {
  return launch_eval<float>(a, static_cast<cudaStream_t>(stream));
}
extern "C" int tsl_element_eval_f64(EvalArgs* a, void* stream) {
  return launch_eval<double>(a, static_cast<cudaStream_t>(stream));
}
extern "C" int tsl_element_fuse_f32(FuseArgs* a, void* stream) {
  return launch_fuse<float>(a, static_cast<cudaStream_t>(stream));
}
extern "C" int tsl_element_fuse_f64(FuseArgs* a, void* stream) {
  return launch_fuse<double>(a, static_cast<cudaStream_t>(stream));
}

#else

extern "C" int tsl_element_eval_host_f32(EvalArgs* a) { return host_eval<float>(a); }
extern "C" int tsl_element_eval_host_f64(EvalArgs* a) { return host_eval<double>(a); }
extern "C" int tsl_element_fuse_host_f32(FuseArgs* a) { return host_fuse<float>(a); }
extern "C" int tsl_element_fuse_host_f64(FuseArgs* a) { return host_fuse<double>(a); }

#endif
